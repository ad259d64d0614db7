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
both copies); under NCCL a host tensor goes to the rank's device.  The
caller picks the backend; nothing falls back from one to the other.

Without a default group every axis must have size 1, and every
collective returns its input: a 1×1 mesh works in any process.  In a
group, an axis of size 1 has its one-rank groups too, so a 1×1 mesh of
one NCCL rank runs every collective of the code through NCCL.
``stats[axis]`` counts each collective over an axis (``calls``) and the
bytes this rank hands to it (``bytes``).
"""
from __future__ import annotations

import itertools
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve


class Mesh:
    """A ``shape``-shaped mesh of ranks with named ``axes``, over the
    initialised default process group (see module docstring)."""

    def __init__(self, shape, axes, *, device="cuda"):
        shape = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                             "up, with distinct axis names")
        size = int(np.prod(shape))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != size:
            raise ValueError(f"mesh {shape} holds {size} ranks but the "
                             f"process group has {world}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.device = resolve(device)
        self._coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self._groups: dict[str, tuple] = {}
        for i, ax in enumerate(axes):
            if not dist.is_initialized():
                break
            others = [range(s) for j, s in enumerate(shape) if j != i]
            for fixed in itertools.product(*others):
                ranks = []
                for c in range(shape[i]):
                    coord = list(fixed)
                    coord.insert(i, c)
                    ranks.append(int(np.ravel_multi_index(coord, shape)))
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[ax] = (group, ranks)
        self.stats = {ax: {"calls": 0, "bytes": 0} for ax in axes}
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
        self.staged_bytes = 0

    # ------------------------------------------------------------ wiring
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it: the host under gloo, the
        rank's device under NCCL."""
        want = torch.device("cpu") if self.backend != "nccl" \
            else self.device
        if t.device == want:
            return t.contiguous()
        self.staged_bytes += t.numel() * t.element_size()
        return t.to(want).contiguous()

    def _back(self, wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if wire.device == like.device:
            return wire
        self.staged_bytes += wire.numel() * wire.element_size()
        return wire.to(like.device)

    def _group(self, axis: str, wire: torch.Tensor):
        group, ranks = self._groups[axis]
        self.stats[axis]["calls"] += 1
        self.stats[axis]["bytes"] += wire.numel() * wire.element_size()
        return group, ranks

    # ------------------------------------------------------- collectives
    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on dim 0 in axis
        order (``lax.all_gather(..., tiled=True)``)."""
        if axis not in self._groups:
            return t
        wire = self._wire(t)
        group, _ = self._group(axis, wire)
        parts = [torch.empty_like(wire) for _ in range(self.shape[axis])]
        dist.all_gather(parts, wire, group=group)
        return self._back(torch.cat(parts), t)

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
        group, ranks = self._group(axis, wire)
        i = self._coords[axis]
        shape = tuple(t.shape) if recv_shape is None else tuple(recv_shape)
        buf = torch.empty(shape, dtype=wire.dtype, device=wire.device)
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
            group, _ = self._group(ax, wire)
            dist.all_reduce(wire, op=op, group=group)
        return self._back(wire, t)

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum over one axis or several (one all-reduce per axis)."""
        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, axis: str, src: int = 0
                  ) -> torch.Tensor:
        """Axis position ``src``'s ``t`` on every rank of the line."""
        if axis not in self._groups:
            return t
        wire = self._wire(t)
        if wire is t:
            wire = t.clone()
        group, ranks = self._group(axis, wire)
        dist.broadcast(wire, src=ranks[src], group=group)
        return self._back(wire, t)

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()
