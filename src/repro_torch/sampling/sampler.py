"""The `Sampler` facade (PyTorch port of ``repro.sampling.sampler``, IC with
the dense frontier).

Batch ``b`` under ``master_seed`` draws its roots from
``rrr.batch_starts`` and its counter seed from ``rrr.batch_seed`` on every
backend, so a given ``(master_seed, batch_index)`` gives the same
``(V, W)`` visited mask here as in the reference:

* ``dense``  — CSR edge-centric sweep (`core.traversal.run_fused`);
* ``tiled``, ``kernel`` — block-sparse tiles through
               `kernels.ops.fused_expand`: the hand-written CUDA kernel on a
               GPU, its plain PyTorch version on CPU tensors.  The reference
               keeps a pure-array ``tiled`` path beside its Pallas kernel;
               the port has one tile expansion, so the two names are the
               same backend.

Samplers run on their graph's device.  LT, the sparse frontier and the
mesh backends come with later slices of the port.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import rrr, tiled_traversal, tiles, traversal
from repro_torch.graph import csr
from repro_torch.sampling.spec import SamplerSpec

__all__ = ["Sampler", "make_sampler"]

_LATER = {
    "lt": "the LT slice (core/lt.py and the lt_select_expand kernel)",
    "sparse": "the sparse-frontier slice (core/sparse.py)",
    "data_parallel": "the multi-GPU slice (torch.distributed samplers)",
    "graph_parallel": "the multi-GPU slice (torch.distributed samplers)",
}


class Sampler:
    """Backend-agnostic sampling handle bound to one (graph, spec) pair.

    ``sample(batch_index)`` returns one `rrr.RRRBatch`;
    ``sample_many(batch_indices)`` a list of them.
    """

    def __init__(self, g: csr.Graph | None, spec: SamplerSpec, *,
                 g_rev: csr.Graph | None = None):
        if g is None and g_rev is None:
            raise ValueError("need g or g_rev")
        self.graph = g
        self.spec = spec
        self.g_rev = g_rev if g_rev is not None else csr.transpose(g)

    def batch_starts(self, batch_index: int) -> np.ndarray:
        """(num_colors,) roots — the shared cross-backend derivation."""
        return rrr.batch_starts(self.g_rev.num_vertices, self.spec.num_colors,
                                self.spec.master_seed, batch_index,
                                sort=self.spec.sort_starts)

    def batch_seed(self, batch_index: int) -> int:
        return rrr.batch_seed(self.spec.master_seed, batch_index)

    def sample(self, batch_index: int) -> rrr.RRRBatch:
        raise NotImplementedError

    def sample_many(self, batch_indices) -> list[rrr.RRRBatch]:
        return [self.sample(int(b)) for b in batch_indices]


class DenseSampler(Sampler):
    """CSR edge-centric path; batches carry real edge-visit totals."""

    def sample(self, batch_index: int) -> rrr.RRRBatch:
        return rrr.sample_batch(
            self.g_rev, self.spec.num_colors, self.spec.master_seed,
            int(batch_index), sort_starts=self.spec.sort_starts,
            max_levels=self.spec.max_iters)

    def sample_many(self, batch_indices) -> list[rrr.RRRBatch]:
        idx = [int(b) for b in batch_indices]
        if not idx:
            return []
        starts = np.stack([self.batch_starts(b) for b in idx])
        seeds = rrr.batch_seeds(self.spec.master_seed, idx)
        vis, fused, unfused = traversal.run_fused_block(
            self.g_rev, starts, seeds, self.spec.num_colors,
            max_levels=self.spec.max_iters)
        return [rrr.RRRBatch(vis[i], starts[i], b, int(fused[i]),
                             int(unfused[i]))
                for i, b in enumerate(idx)]


class TiledSampler(Sampler):
    """Block-sparse tile path (``tiled`` and ``kernel`` alike, through
    `kernels.ops.fused_expand`).  The tile layout of the reversed graph is built
    once per graph object (`tiles.cached`) and shared by every sampler over
    it.  Requires a parallel-edge-free graph (``csr.dedupe``)."""

    def __init__(self, g, spec, *, g_rev=None):
        super().__init__(g, spec, g_rev=g_rev)
        try:
            self.tg_rev = tiles.cached(self.g_rev, spec.tile_size)
        except ValueError as e:
            raise ValueError(
                f"the {spec.backend!r} backend needs a dedupe-clean graph "
                "(build it with csr.dedupe or from_edges(..., dedupe=True)); "
                f"tiling failed with: {e}") from e

    def sample(self, batch_index: int) -> rrr.RRRBatch:
        starts = self.batch_starts(batch_index)
        visited, _, _ = tiled_traversal.run_fused_tiled(
            self.tg_rev, starts, self.spec.num_colors,
            self.batch_seed(batch_index), max_levels=self.spec.max_iters)
        return rrr.RRRBatch(visited, starts, int(batch_index), -1, -1)


def make_sampler(g: csr.Graph | None, spec: SamplerSpec, *,
                 g_rev: csr.Graph | None = None) -> Sampler:
    """Build the `Sampler` for ``spec`` on the graph's device.

    ``g_rev``: prebuilt transpose(g) (skips one reversal).  Cells of the
    reference's matrix that the port has not reached yet raise
    ``NotImplementedError`` naming their slice.
    """
    for knob in (spec.diffusion, spec.frontier, spec.backend):
        if knob in _LATER:
            raise NotImplementedError(
                f"{knob!r} is not ported yet: it comes with {_LATER[knob]}")
    if spec.backend in ("tiled", "kernel"):
        return TiledSampler(g, spec, g_rev=g_rev)
    return DenseSampler(g, spec, g_rev=g_rev)
