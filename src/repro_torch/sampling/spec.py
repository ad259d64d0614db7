"""Typed sampler specification (PyTorch port of ``repro.sampling.spec``).

``SamplerSpec`` keeps the reference's fields and validation, so a spec
round-trips between the two packages unchanged.  The port implements both
diffusions and both frontier modes on every backend; the mesh backends
(``data_parallel``, ``graph_parallel``) take a `distributed.comm.Mesh`.

The RNG contract every backend honors: batch ``b`` under ``master_seed`` is
a pure function of ``(graph, master_seed, b)``, so supported backends are
bit-identical per batch index — and bit-identical to the reference.
"""
from __future__ import annotations

import dataclasses

DIFFUSIONS = ("ic", "lt")
BACKENDS = ("dense", "tiled", "kernel", "data_parallel", "graph_parallel")
FRONTIERS = ("dense", "sparse")

# (diffusion, backend) pairs with an implementation behind them: every
# cell, as in the reference.
_SUPPORTED = frozenset(
    (d, b) for d in DIFFUSIONS for b in BACKENDS)


def supported(diffusion: str, backend: str) -> bool:
    """True iff the (diffusion, backend) cell of the matrix is
    implemented."""
    return (diffusion, backend) in _SUPPORTED


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Complete description of one traversal-sampling configuration.

    ``max_iters`` is the level cap of the level-synchronous traversal;
    ``tile_size`` matters to the tile-layout backends (tiled/kernel) and
    sets the sparse frontier's row-block height.  ``frontier="sparse"``
    compacts each level to the active part of the graph;
    ``frontier_capacity`` shapes its ladder (0 = auto), and on the
    ``graph_parallel`` backend the sparse exchange's capacity.  The mesh
    backends split batches over ``mesh_axis`` and, for
    ``graph_parallel``, the graph's rows over ``model_axis``.
    """
    diffusion: str = "ic"
    backend: str = "dense"
    num_colors: int = 64
    master_seed: int = 0
    max_iters: int = 64
    sort_starts: bool = False
    tile_size: int = 128
    mesh_axis: str = "data"
    model_axis: str = "model"
    frontier: str = "dense"
    frontier_capacity: int = 0

    def __post_init__(self):
        if self.diffusion not in DIFFUSIONS:
            raise ValueError(f"diffusion {self.diffusion!r} not in "
                             f"{DIFFUSIONS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.num_colors < 1 or self.max_iters < 1 or self.tile_size < 1:
            raise ValueError("num_colors / max_iters / tile_size must be ≥ 1")
        if self.frontier not in FRONTIERS:
            raise ValueError(f"frontier {self.frontier!r} not in {FRONTIERS}")
        if self.frontier_capacity < 0:
            raise ValueError("frontier_capacity must be ≥ 0 (0 = auto)")
        if self.backend == "graph_parallel" \
                and self.mesh_axis == self.model_axis:
            raise ValueError(
                "graph_parallel needs DISTINCT axes: mesh_axis (batches) "
                f"and model_axis (graph rows) are both {self.mesh_axis!r}")

    def replace(self, **kw) -> "SamplerSpec":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------- manifest round-trip
    def to_manifest(self) -> dict:
        """JSON-serialisable form for a checkpoint manifest's ``extra``
        (the reference's dict, so snapshots cross between the packages)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_manifest(cls, d: dict) -> "SamplerSpec":
        """Inverse of ``to_manifest`` (unknown keys ignored)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def resolve_spec(spec: SamplerSpec | None = None, *,
                 num_colors: int | None = None,
                 master_seed: int | None = None) -> SamplerSpec:
    """The one spec-vs-arguments reconciliation policy.

    ``num_colors``/``master_seed`` are ``None`` when the caller did not set
    them.  An explicit ``spec`` wins over unset arguments; a set argument
    that disagrees with the spec raises — never a silent override.
    """
    if spec is None:
        return SamplerSpec(num_colors=64 if num_colors is None else num_colors,
                           master_seed=0 if master_seed is None
                           else master_seed)
    for name, mine in (("num_colors", num_colors),
                       ("master_seed", master_seed)):
        theirs = getattr(spec, name)
        if mine is not None and mine != theirs:
            raise ValueError(f"{name}={mine} conflicts with "
                             f"spec.{name}={theirs} — set it in one place")
    return spec
