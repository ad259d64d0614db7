"""ZeRO-3 sharded training over a `distributed.comm.Mesh`: the shard
bookkeeping and the autograd functions that move parameters, gradients
and MoE tokens between the ranks.

This module has no counterpart in the reference: there GSPMD places each
leaf by ``sharding_rules.param_shardings``, all-gathers it where a layer
uses it, and reduce-scatters each microbatch's gradient into the shards
because ``constrain_params`` re-asserts their layout.  Here one process
runs each mesh position and does those moves itself:

* `Layout` holds each leaf's spec (`sharding_rules.param_shardings`,
  `models.model.layout_on`) and full shape.  A rank stores only its
  slice of every leaf (`Layout.local`): dimension ``k`` of spec entry
  ``(a1, a2)`` is cut into ``|a1|·|a2|`` blocks and the rank keeps block
  ``c_a1·|a2| + c_a2`` (the first axis major, as a ``PartitionSpec``
  entry of several axes splits).  Its AdamW moments and gradient
  accumulators have the same slice.
* `gather` all-gathers a leaf to full size where a layer uses it.  Its
  backward sums the full-size gradient over every rank and keeps this
  rank's slice: a reduce-scatter over the gathered axes, an all-reduce
  over the axes the leaf is replicated on.  The result is added to the
  layout's ``sink`` (the step's gradient accumulators, float32 when the
  step has several microbatches, as the reference's ``g32``), and no
  gradient flows to the shard itself.  `gather_module` gathers one
  layer's leaves; the MoE's expert stacks may instead be gathered over
  the fsdp axes only and resharded over ``model`` onto whole experts
  (`_experts_view`), so that each rank holds E/S experts.
* `one_rank` is the layout of a model held whole by one process alone:
  one-device training runs the same step on it, every collective its
  input.  On such a mesh (no group) nothing is gathered: the forward
  uses the leaves themselves, and a hook on each leaf adds its gradient
  to the sink (`Layout.attach`).
* `all_to_all` and `psum` are `Mesh.all_to_all` and `Mesh.psum` under
  autograd (the MoE's token exchange and its aux loss's sums); the
  backward of each is itself.  Every rank's loss is its share of the
  global loss, whose gradient is the sum of the ranks' gradients.

Every collective, in the backward too, comes in the same order on every
rank because every rank runs the same graph.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed import comm
from repro_torch.distributed import sharding_rules as rules


class Layout:
    """Where each leaf of a model lives on ``mesh`` (module docstring):
    ``specs`` and full ``shapes`` by parameter name."""

    def __init__(self, mesh, specs: dict, shapes: dict):
        self.mesh, self.specs = mesh, dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.names: dict[int, str] = {}
        self.sink: dict | None = None

    # ---------------------------------------------------------- slices
    def _block(self, entry) -> tuple[int, int]:
        """(this rank's block along a dimension of spec ``entry``, the
        number of blocks)."""
        index, ways = 0, 1
        for a in rules.entry_axes(entry):
            index = index * self.mesh.shape[a] + self.mesh.axis_index(a)
            ways *= self.mesh.shape[a]
        return index, ways

    def slices(self, name: str) -> tuple:
        out = []
        for n, entry in zip(self.shapes[name], self.specs[name]):
            i, ways = self._block(entry)
            out.append(slice(i * n // ways, (i + 1) * n // ways))
        return tuple(out)

    def local_shape(self, name: str) -> tuple:
        return tuple(s.stop - s.start for s in self.slices(name))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full-size ``full`` (a copy of its own,
        so the full tensor can go; ``full`` itself where the rank holds it
        whole)."""
        if tuple(full.shape) != self.shapes[name]:
            raise ValueError(f"{name}: shape {tuple(full.shape)}, the "
                             f"layout has {self.shapes[name]}")
        if self.local_shape(name) == self.shapes[name]:
            return full
        return full[self.slices(name)].clone()

    def sharded_axes(self, name: str) -> tuple:
        """The axes the leaf is split over, in the mesh's order."""
        used = {a for e in self.specs[name] for a in rules.entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def replicated_axes(self, name: str) -> tuple:
        used = self.sharded_axes(name)
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def local_bytes(self, named: dict) -> int:
        """Bytes of ``named``'s tensors (name → tensor) at this rank's
        slice shapes, each in its own dtype: what the shards must take."""
        return sum(math.prod(self.local_shape(k)) * t.element_size()
                   for k, t in named.items())

    # ------------------------------------------------------- whole tree
    def attach(self, params: nn.Module) -> nn.Module:
        """Record ``params``' leaves (already sharded) under their names;
        `gather_module` finds a leaf's name by its identity.  On a mesh
        without a group (`one_rank`) nothing is gathered: the forward uses
        each leaf whole, and a hook on the leaf moves its gradient into
        the sink (`_to_sink`)."""
        for name, p in params.named_parameters():
            if tuple(p.shape) != self.local_shape(name):
                raise ValueError(f"{name}: shard {tuple(p.shape)}, the "
                                 f"layout has {self.local_shape(name)}")
            self.names[id(p)] = name
            if self.mesh.backend is None:
                p.register_post_accumulate_grad_hook(self._to_sink)
        params.fsdp = self
        return params

    def _to_sink(self, p: torch.Tensor) -> None:
        """A whole leaf's gradient, just accumulated in ``p.grad``, added
        to the step's sink and dropped (left in ``.grad`` outside a
        step), so that no more than a leaf's gradient waits beside it."""
        if self.sink is not None:
            self.sink[self.names[id(p)]].add_(p.grad)
            p.grad = None

    def shard(self, params: nn.Module) -> nn.Module:
        """Cut every full-size leaf of ``params`` to this rank's slice in
        place, and `attach` the layout."""
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.data = self.local(name, p.data)
        return self.attach(params)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full-size leaf from every rank's slice ``t`` (no
        autograd)."""
        for dim, entry in enumerate(self.specs[name]):
            t = gather_dim(t, dim, entry, self.mesh)
        return t


def layout_of(params, mesh) -> Layout:
    lay = getattr(params, "fsdp", None)
    if lay is None or lay.mesh is not mesh:
        raise ValueError("the parameters are not sharded on this mesh: "
                         "shard them with model.layout_on(mesh, cfg).shard")
    return lay


def one_rank(params: nn.Module) -> Layout:
    """The layout of ``params`` held whole by this process alone: a mesh
    of one rank (`comm.Mesh` with ``alone``, every collective its input)
    on which every leaf is replicated, so that one-device training is the
    sharded step's one-rank case.  Attached on first use (and again to a
    copy of the parameters), once: `Layout.attach` hooks each leaf."""
    lay = getattr(params, "fsdp", None)
    named = dict(params.named_parameters())
    if lay is not None and all(id(p) in lay.names for p in named.values()):
        if mesh_size(lay.mesh) != 1:
            raise ValueError(f"the parameters are sharded on {lay.mesh}: "
                             "train them on that mesh")
        return lay
    dev = next(iter(named.values())).device
    mesh = comm.Mesh((1,), ("data",), device=dev, alone=True)
    shapes = {k: tuple(t.shape) for k, t in named.items()}
    lay = Layout(mesh, {k: (None,) * len(v) for k, v in shapes.items()},
                 shapes)
    lay.attach(params)
    return lay


# ------------------------------------------------------------- collectives
def gather_dim(t, dim: int, entry, mesh, keep=()) -> torch.Tensor:
    """All-gather dimension ``dim`` of ``t`` over the axes of spec
    ``entry`` (the last axis first, so the first ends up major)."""
    axes = [a for a in rules.entry_axes(entry) if a not in keep]
    if not axes or mesh.backend is None:    # no group: every axis size 1
        return t
    t = t.movedim(dim, 0)
    for a in reversed(axes):
        t = mesh.all_gather(t.contiguous(), a)
    return t.movedim(0, dim)


def _scatter_dim(g, dim: int, entry, mesh, keep=()) -> torch.Tensor:
    """Sum ``g`` over the axes of ``entry`` and keep this rank's block of
    dimension ``dim`` (the inverse of `gather_dim`: the first axis
    first)."""
    axes = [a for a in rules.entry_axes(entry) if a not in keep]
    if not axes:
        return g
    g = g.movedim(dim, 0)
    for a in axes:
        g = mesh.reduce_scatter(g.contiguous(), a)
    return g.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """The full-size leaf (module docstring); ``keep``: axes left
    sharded."""

    @staticmethod
    def forward(ctx, shard, layout: Layout, name: str, keep: tuple):
        ctx.layout, ctx.name, ctx.keep = layout, name, keep
        t = shard
        for dim, entry in enumerate(layout.specs[name]):
            t = gather_dim(t, dim, entry, layout.mesh, keep)
        return t.view_as(t) if t is shard else t

    @staticmethod
    def backward(ctx, g):
        lay, name, keep = ctx.layout, ctx.name, ctx.keep
        if lay.sink is None:
            raise RuntimeError("a sharded leaf's gradient has nowhere to go: "
                               "the training step sets Layout.sink")
        sink = lay.sink[name]
        g = g.to(sink.dtype)
        for dim, entry in enumerate(lay.specs[name]):
            g = _scatter_dim(g, dim, entry, lay.mesh, keep)
        rep = lay.replicated_axes(name)
        if rep:
            g = lay.mesh.psum(g, rep)
        sink.add_(g)
        return None, None, None, None


def gather(shard: torch.Tensor, layout: Layout, keep: tuple = ()):
    """``shard``'s leaf at full size (over every axis but ``keep``), its
    gradient summed into ``layout.sink`` (module docstring)."""
    return _Gather.apply(shard, layout, layout.names[id(shard)], keep)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(t, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axis), None, None


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """`Mesh.all_to_all` under autograd: its backward is the same
    exchange."""
    return _AllToAll.apply(t, mesh, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes: tuple):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.psum(t, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None


def psum(t: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """`Mesh.psum` over ``axes`` (default every axis) under autograd: the
    global sum that every rank's share of the loss uses, so its gradient
    is the sum of the ranks' upstream gradients."""
    axes = tuple(mesh.axis_names) if axes is None else tuple(axes)
    return _Psum.apply(t, mesh, axes)


def all_gather_ranks(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order (R, …) (no autograd)."""
    t = t[None]
    for a in reversed(mesh.axis_names):
        t = mesh.all_gather(t.contiguous(), a)
    return t


def mesh_size(mesh) -> int:
    return math.prod(mesh.shape.values())


# --------------------------------------------------------------- layers
class View:
    """A layer's leaves gathered: ``kind`` and the module's children by
    name, a ``ParameterDict`` as a dict (module docstring)."""

    def __init__(self, kind: str, fields: dict):
        self.kind = kind
        self.__dict__.update(fields)


def _experts_view(shard, layout: Layout, e_local: int):
    """An expert stack (E, …) resharded onto this rank's E/S whole
    experts (the a2a route): gathered over every axis but ``model``; a
    dimension split over ``model`` is then exchanged for the expert
    dimension by one all-to-all over ``model``.  A stack that the layout
    replicates over ``model`` is gathered whole and sliced."""
    mesh, name = layout.mesh, layout.names[id(shard)]
    s, m = mesh.shape["model"], mesh.axis_index("model")
    spec = layout.specs[name]
    if "model" not in layout.sharded_axes(name):
        return gather(shard, layout)[m * e_local:(m + 1) * e_local]
    k = next(i for i, e in enumerate(spec) if "model" in rules.entry_axes(e))
    if k == 0 or rules.entry_axes(spec[k]) != ("model",):
        raise ValueError(f"{name}: spec {spec} does not split a non-expert "
                         "dimension over model alone")
    t = gather(shard, layout, keep=("model",))       # (E, …, X/S, …)
    e = t.shape[0]
    t = t.reshape(s, e // s, *t.shape[1:])          # (S, E/S, …, X/S, …)
    t = all_to_all(t.contiguous(), mesh, "model")   # [j]: rank j's X block
    return torch.cat(t.unbind(0), dim=k)            # (E/S, …, X, …)


def gather_module(mod: nn.Module, layout: Layout, experts_local: int = 0):
    """``mod``'s leaves at full size, as a `View` (a ``ParameterDict``
    as a dict).  With ``experts_local`` E/S > 0, the ``experts_*`` stacks
    come as this rank's whole experts (`_experts_view`)."""
    def leaf(key, t):
        if experts_local and key.startswith("experts_"):
            return _experts_view(t, layout, experts_local)
        return gather(t, layout)

    def walk(m):
        if isinstance(m, nn.ParameterDict):
            return {k: walk(v) if isinstance(v, nn.Module) else leaf(k, v)
                    for k, v in m.items()}
        fields = {k: leaf(k, v) for k, v in m._parameters.items()
                  if v is not None}
        fields.update({k: walk(v) for k, v in m._modules.items()
                       if v is not None})
        return View(getattr(m, "kind", None), fields)

    return walk(mod)


def local_rows(batch: dict, mesh, num_microbatches: int) -> dict:
    """This rank's rows of a global batch, microbatch by microbatch:
    microbatch i is global rows [iB/M, (i+1)B/M) (the reference's
    reshape), of which rank q (its row-major position on the mesh, as
    `comm.Mesh` numbers its ranks) takes the q-th of R equal runs; the
    result holds M such runs in order, so that a reshape to
    (M, B/(M·R), …) gives the rank's part of each microbatch."""
    m, r, q = num_microbatches, mesh_size(mesh), mesh.rank
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        check_rows(b, m, tuple(mesh.shape.values()))
        per = b // m // r
        out[k] = torch.cat([x[i * (b // m) + q * per:
                              i * (b // m) + (q + 1) * per]
                            for i in range(m)])
    return out


def check_rows(batch: int, num_microbatches: int, mesh_shape) -> None:
    """Raise ValueError unless each of the ``num_microbatches``
    microbatches of ``batch`` rows splits evenly over the mesh's ranks."""
    r = math.prod(mesh_shape)
    if batch % num_microbatches or (batch // num_microbatches) % r:
        raise ValueError(
            f"a global batch of {batch} rows in {num_microbatches} "
            f"microbatches does not split over the {r} ranks of mesh "
            f"{'x'.join(str(s) for s in mesh_shape)}: each microbatch's "
            f"B/M = {batch / num_microbatches:g} rows must divide by {r}")
