"""SPMD mesh over ``torch.distributed`` process groups (the port's
counterpart of the reference's ``jax`` mesh and the collectives its
``shard_map`` bodies call, ``repro/distributed/compat.py``).

The reference has one controller: one process maps a body over the mesh.
The port runs one process per mesh position instead.  Rank ``r`` of an
initialised default group sits at the row-major position of ``r`` in
``shape`` (rank ``d·M + m`` of a ``(D, M)`` mesh), every rank builds the
same `Mesh` and calls the same collectives in the same order.  For every
axis the mesh holds one subgroup per line along it (``dist.new_group``:
every rank creates every group, in one order, as the call requires).

Transport.  ``backend`` is the default group's: NCCL on GPUs with one
device per rank, gloo over CPU processes and for several ranks sharing one
GPU (NCCL refuses two ranks on one device).  Under gloo a device tensor is
copied to the host for the collective and back (``staged_bytes`` counts
both copies), through page-locked buffers on a mesh whose device is a
card (torch's caching host allocator keeps them for the next call), and
a collective's result lands in one such buffer; under NCCL a host tensor
goes to the rank's device.  The caller picks the backend; nothing falls
back from one to the other.

``members`` (global ranks, ascending: a group orders its ranks so, and
the mesh's positions follow) builds the mesh over those ranks of the
default group alone, so that one started world can hold
meshes of several sizes: every rank of the group must still construct
it (creating a group is collective over the whole default group), and
on a rank outside ``members`` it is a bystander (``member`` False,
``rank`` None) that takes part in nothing.

Without a default group every axis must have size 1, and every
collective returns its input: a 1×1 mesh works in any process, and
``alone=True`` makes such a mesh of this process alone even inside a
group (one-device training, `distributed.fsdp.one_rank`).  In a group,
an axis of size 1 has its one-rank groups too, so a 1×1 mesh of one NCCL
rank runs every collective of the code through NCCL.
``stats[axis]`` counts each collective over an axis (``calls``) and the
bytes this rank hands to it (``bytes``); ``collective_log[kind][axis]``
counts the same calls by kind (``all_gather``, ``all_to_all``,
``reduce_scatter``, ``ppermute``, ``all_reduce`` for `psum` and `pmax`,
``broadcast``) with the bytes of their results, what a cost model of the
wire reads (`launch.cost_analysis`).  ``timeout_s`` bounds each
collective of the axis groups (default: the default group's timeout).

`ShapeMesh` is a mesh of shapes alone: the same positions, counts and
log for one rank of a mesh of any size, with no process group, whose
collectives return meta tensors of the shapes a real mesh's would.  The
dry-run (`launch.dryrun`) traces a rank's program on it.
"""
from __future__ import annotations

import datetime
import itertools
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve


class Mesh:
    """A ``shape``-shaped mesh of ranks with named ``axes``, over the
    initialised default process group (see module docstring)."""

    def __init__(self, shape, axes, *, device="cuda", timeout_s=None,
                 alone=False, members=None):
        shape = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                             "up, with distinct axis names")
        size = int(np.prod(shape))
        grouped = dist.is_initialized() and not alone
        if members is not None:
            members = tuple(int(r) for r in members)
            if not grouped or list(members) != sorted(set(members)) \
                    or not all(0 <= r < dist.get_world_size()
                               for r in members):
                raise ValueError(f"members {members} must be ascending "
                                 "ranks of an initialised default group")
        world = (len(members) if members is not None
                 else dist.get_world_size()) if grouped else 1
        if world != size:
            raise ValueError(f"mesh {shape} holds {size} ranks but the "
                             f"process group has {world}")
        me = dist.get_rank() if grouped else 0
        glob = members or tuple(range(size))       # mesh position → rank
        self.member = me in glob
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.rank = glob.index(me) if self.member else None
        self.backend = dist.get_backend() if grouped else None
        self.device = resolve(device)
        self._coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            self.rank, shape)))) if self.member else {}
        self._groups: dict[str, tuple] = {}
        timeout = None if timeout_s is None \
            else datetime.timedelta(seconds=timeout_s)
        self._whole = None
        if grouped and members is not None:
            self._whole = dist.new_group(list(glob), timeout=timeout)
        for i, ax in enumerate(axes):
            if not grouped:
                break
            others = [range(s) for j, s in enumerate(shape) if j != i]
            for fixed in itertools.product(*others):
                ranks = []
                for c in range(shape[i]):
                    coord = list(fixed)
                    coord.insert(i, c)
                    ranks.append(glob[int(np.ravel_multi_index(coord,
                                                               shape))])
                group = dist.new_group(ranks, timeout=timeout)
                if me in ranks:
                    self._groups[ax] = (group, ranks)
        self.stats = {ax: {"calls": 0, "bytes": 0} for ax in axes}
        self.collective_log: dict = {}
        self.staged_bytes = 0

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, backend "
                f"{self.backend}, device {self.device})")

    # ---------------------------------------------------------- position
    def axis_index(self, axis: str) -> int:
        return self._coords[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def reset_stats(self) -> None:
        for s in self.stats.values():
            s["calls"] = s["bytes"] = 0
        self.collective_log = {}
        self.staged_bytes = 0

    def _count(self, kind: str, axis: str, sent: int, result: int) -> None:
        """One collective over ``axis``: ``sent`` bytes handed to it,
        ``result`` bytes of what it returns (module docstring)."""
        self.stats[axis]["calls"] += 1
        self.stats[axis]["bytes"] += sent
        log = self.collective_log.setdefault(kind, {}).setdefault(
            axis, {"calls": 0, "bytes": 0})
        log["calls"] += 1
        log["bytes"] += result

    # ------------------------------------------------------------ wiring
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it: the host under gloo (a
        page-locked copy of a card's tensor), the rank's device under
        NCCL."""
        want = torch.device("cpu") if self.backend != "nccl" \
            else self.device
        if t.device == want:
            return t.contiguous()
        self.staged_bytes += t.numel() * t.element_size()
        if want.type == "cpu":
            host = self._empty_like_wire(t.shape, t.dtype, want)
            host.copy_(t)
            return host
        return t.to(want).contiguous()

    def _empty_like_wire(self, shape, dtype, device) -> torch.Tensor:
        """An uninitialised buffer on the wire's ``device``; a host one is
        page-locked when this mesh's device is a card."""
        if device.type == "cpu":
            return torch.empty(tuple(shape), dtype=dtype,
                               pin_memory=self.device.type == "cuda")
        return torch.empty(tuple(shape), dtype=dtype, device=device)

    def _back(self, wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if wire.device == like.device:
            return wire
        self.staged_bytes += wire.numel() * wire.element_size()
        return wire.to(like.device)

    def _group(self, axis: str, wire: torch.Tensor, kind: str,
               result: int | None = None):
        """The axis's group and ranks, the call counted (`_count`;
        ``result`` defaults to the bytes sent)."""
        sent = wire.numel() * wire.element_size()
        self._count(kind, axis, sent, sent if result is None else result)
        return self._groups[axis]

    # ------------------------------------------------------- collectives
    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on dim 0 in axis
        order (``lax.all_gather(..., tiled=True)``)."""
        if axis not in self._groups:
            return t
        wire = self._wire(t)
        s = self.shape[axis]
        group, _ = self._group(axis, wire, "all_gather", _nbytes(wire) * s)
        out = self._empty_like_wire((s, *wire.shape), wire.dtype,
                                    wire.device)
        dist.all_gather(list(out.unbind(0)), wire, group=group)
        return self._back(out.view(s * wire.shape[0], *wire.shape[1:]), t)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Block ``i`` of ``t``'s dim 0 (size S, the axis's) goes to axis
        position ``i``; block ``j`` of the result is what position ``j``
        sent (``lax.all_to_all(t, axis, 0, 0, tiled=False)``), in one
        ``all_to_all_single``."""
        s = self.shape[axis]
        if t.shape[0] != s:
            raise ValueError(f"all_to_all over {axis!r} (size {s}) needs "
                             f"dim 0 of size {s}, got {tuple(t.shape)}")
        if axis not in self._groups:
            return t
        wire = self._wire(t)
        group, _ = self._group(axis, wire, "all_to_all")
        out = self._empty_like_wire(wire.shape, wire.dtype, wire.device)
        dist.all_to_all_single(out, wire, group=group)
        return self._back(out, t)

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` of every rank's ``t``, cut into S blocks
        along dim 0 (S the axis's size, which must divide it): this rank
        keeps block ``axis_index(axis)`` (``lax.psum_scatter(...,
        tiled=True)``).  NCCL's ``reduce_scatter_tensor``; gloo has none,
        so there one ``all_to_all_single`` and a local sum."""
        s = self.shape[axis]
        if t.shape[0] % s:
            raise ValueError(f"reduce_scatter over {axis!r} (size {s}) "
                             f"needs dim 0 divisible by {s}, got "
                             f"{tuple(t.shape)}")
        if axis not in self._groups:
            return t
        wire = self._wire(t)
        group, _ = self._group(axis, wire, "reduce_scatter",
                               _nbytes(wire) // s)
        if self.backend == "nccl":
            out = torch.empty((t.shape[0] // s, *t.shape[1:]),
                              dtype=wire.dtype, device=wire.device)
            dist.reduce_scatter_tensor(out, wire, group=group)
        else:
            parts = self._empty_like_wire(wire.shape, wire.dtype,
                                          wire.device)
            dist.all_to_all_single(parts, wire, group=group)
            out = parts.view(s, -1, *t.shape[1:]).sum(0)
        return self._back(out, t)

    def ppermute(self, t: torch.Tensor, axis: str, shift: int,
                 recv_shape=None) -> torch.Tensor:
        """Send ``t`` to axis position ``(i − shift) mod S`` and return what
        ``(i + shift) mod S`` sent, of ``recv_shape`` (default ``t``'s), in
        one ``batch_isend_irecv``.  An empty tensor is not sent: a
        receiver expecting zero elements posts no receive."""
        s = self.shape[axis]
        if s == 1 or shift % s == 0:
            return t
        wire = self._wire(t)
        shape = tuple(t.shape) if recv_shape is None else tuple(recv_shape)
        buf = self._empty_like_wire(shape, wire.dtype, wire.device)
        group, ranks = self._group(axis, wire, "ppermute", _nbytes(buf))
        i = self._coords[axis]
        ops = []
        if wire.numel():
            ops.append(dist.P2POp(dist.isend, wire, ranks[(i - shift) % s],
                                  group=group))
        if buf.numel():
            ops.append(dist.P2POp(dist.irecv, buf, ranks[(i + shift) % s],
                                  group=group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._back(buf, t)

    def _reduce(self, t: torch.Tensor, axes, op) -> torch.Tensor:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        live = [ax for ax in axes if ax in self._groups]
        if not live:
            return t
        wire = self._wire(t)
        if wire is t:
            wire = t.clone()
        for ax in live:
            group, _ = self._group(ax, wire, "all_reduce")
            dist.all_reduce(wire, op=op, group=group)
        return self._back(wire, t)

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum over one axis or several (one all-reduce per axis)."""
        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, axis: str | None = None,
                  src: int = 0, *, axes=None) -> torch.Tensor:
        """Axis position ``src``'s ``t`` on every rank of the line; with
        ``axes`` instead, global rank 0's ``t`` on every rank of those
        axes: one broadcast from position 0 per axis, in the mesh's axis
        order (after the broadcast over an axis, every rank whose later
        coordinates are 0 holds rank 0's value, so the next axis's
        position 0 sends it on)."""
        if axes is None:
            axes = (axis,)
        elif axis is not None or src != 0:
            raise ValueError("broadcast takes axis (and src) or axes, "
                             "which sends from rank 0")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not set(axes) <= set(self.axis_names):
            raise ValueError(f"axes {axes} not all in {self.axis_names}")
        live = [ax for ax in self.axis_names
                if ax in axes and ax in self._groups]
        if not live:
            return t
        wire = self._wire(t)
        if wire is t:
            wire = t.clone()
        for ax in live:
            group, ranks = self._group(ax, wire, "broadcast")
            dist.broadcast(wire, src=ranks[src], group=group)
        return self._back(wire, t)

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier(group=self._whole)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShapeMesh(Mesh):
    """Rank ``rank`` of a ``shape`` mesh with named ``axes``, with no
    process group (module docstring): `Mesh`'s positions, ``stats``,
    ``collective_log`` and ``staged_bytes`` (always 0), and collectives
    that count as a grouped mesh's do (every axis has its groups, those
    of size 1 too) and return empty meta tensors of the shapes a grouped
    mesh would return.  Its ``backend`` is ``"nccl"``, so that code on it
    takes its grouped branches and stages nothing through the host."""

    def __init__(self, shape, axes, rank: int = 0):
        shape = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                             "up, with distinct axis names")
        if not 0 <= rank < int(np.prod(shape)):
            raise ValueError(f"rank {rank} is not on mesh {shape}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.rank, self.member = int(rank), True
        self.backend = "nccl"
        self.device = torch.device("meta")
        self._coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self._groups = {}
        self.stats = {ax: {"calls": 0, "bytes": 0} for ax in axes}
        self.collective_log = {}
        self.staged_bytes = 0

    def __repr__(self) -> str:
        return f"ShapeMesh({self.shape}, rank {self.rank})"

    @staticmethod
    def _meta(shape, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=like.dtype, device="meta")

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        s = self.shape[axis]
        self._count("all_gather", axis, _nbytes(t), _nbytes(t) * s)
        return self._meta((t.shape[0] * s, *t.shape[1:]), t)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        s = self.shape[axis]
        if t.shape[0] != s:
            raise ValueError(f"all_to_all over {axis!r} (size {s}) needs "
                             f"dim 0 of size {s}, got {tuple(t.shape)}")
        self._count("all_to_all", axis, _nbytes(t), _nbytes(t))
        return self._meta(t.shape, t)

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        s = self.shape[axis]
        if t.shape[0] % s:
            raise ValueError(f"reduce_scatter over {axis!r} (size {s}) "
                             f"needs dim 0 divisible by {s}, got "
                             f"{tuple(t.shape)}")
        self._count("reduce_scatter", axis, _nbytes(t), _nbytes(t) // s)
        return self._meta((t.shape[0] // s, *t.shape[1:]), t)

    def ppermute(self, t: torch.Tensor, axis: str, shift: int,
                 recv_shape=None) -> torch.Tensor:
        s = self.shape[axis]
        if s == 1 or shift % s == 0:
            return t
        out = self._meta(t.shape if recv_shape is None else recv_shape, t)
        self._count("ppermute", axis, _nbytes(t), _nbytes(out))
        return out

    def _reduce(self, t: torch.Tensor, axes, op) -> torch.Tensor:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for ax in axes:
            self._count("all_reduce", ax, _nbytes(t), _nbytes(t))
        return self._meta(t.shape, t) if axes else t

    def broadcast(self, t: torch.Tensor, axis: str | None = None,
                  src: int = 0, *, axes=None) -> torch.Tensor:
        if axes is None:
            axes = (axis,)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not set(axes) <= set(self.axis_names):
            raise ValueError(f"axes {axes} not all in {self.axis_names}")
        live = [ax for ax in self.axis_names if ax in axes]
        for ax in live:
            self._count("broadcast", ax, _nbytes(t), _nbytes(t))
        return self._meta(t.shape, t) if live else t

    def barrier(self) -> None:
        pass


class AxesView:
    """``mesh`` seen along ``axes`` alone: the line of ranks that share
    this rank's coordinates on every other axis, as a mesh of its own
    (``axis_names``, ``shape``, ``rank`` its row-major position on the
    line), whose collectives are ``mesh``'s over those axes (and counted
    there).  Serving on a mesh holds its rows over the data axes and the
    same rows on every ``model`` rank; code that must see each row once
    (the MoE's global capacity) runs on the data axes' view."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axis_names = tuple(a for a in mesh.axis_names if a in axes)
        self.shape = {a: mesh.shape[a] for a in self.axis_names}
        self.rank = int(np.ravel_multi_index(
            [mesh.axis_index(a) for a in self.axis_names],
            [self.shape[a] for a in self.axis_names])) \
            if self.axis_names else 0
        self.backend, self.device = mesh.backend, mesh.device

    def __repr__(self) -> str:
        return f"AxesView({self.shape} of {self.mesh!r})"

    def axis_index(self, axis: str) -> int:
        return self.mesh.axis_index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def _own(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not set(axes) <= set(self.axis_names):
            raise ValueError(f"axes {axes} not all in {self.axis_names}")
        return axes

    def all_gather(self, t, axis: str):
        return self.mesh.all_gather(t, self._own(axis)[0])

    def all_to_all(self, t, axis: str):
        return self.mesh.all_to_all(t, self._own(axis)[0])

    def reduce_scatter(self, t, axis: str):
        return self.mesh.reduce_scatter(t, self._own(axis)[0])

    def psum(self, t, axes):
        return self.mesh.psum(t, self._own(axes))

    def pmax(self, t, axes):
        return self.mesh.pmax(t, self._own(axes))
