"""The `Sampler` facade (PyTorch port of ``repro.sampling.sampler``,
single-device backends).

Batch ``b`` under ``master_seed`` draws its roots from
``rrr.batch_starts`` and its counter seed from ``rrr.batch_seed`` on every
backend, so a given ``(master_seed, batch_index)`` gives the same
``(V, W)`` visited mask here as in the reference, for both diffusions and
both frontier modes:

* ``dense``  — CSR edge-centric sweep (`core.traversal.run_fused`,
               `core.lt.run_fused_lt`), or with ``frontier="sparse"`` the
               edge-block compaction engine (`core.sparse`);
* ``tiled``, ``kernel`` — block-sparse tiles through the tile kernels
               (`kernels.ops.fused_expand` for IC, ``lt_select_expand`` for
               LT): the hand-written CUDA kernels on a GPU, their plain
               PyTorch versions on CPU tensors, over every tile or, with
               ``frontier="sparse"``, the compacted tile list.  The
               reference keeps a pure-array ``tiled`` path beside its
               Pallas kernels; the port has one tile expansion, so the two
               names are the same backend.

LT: the facade normalises the live-edge weights of the reversed graph
once per graph object, and uses a graph that already carries the invariant
as it is (`lt.normalized`).  ``rebind`` moves a sampler to a streamed
graph pair (`repro_torch.stream`).  Samplers
run on their graph's device.  The mesh backends come with the multi-GPU
slice of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lt, rrr, sparse, tiled_traversal, tiles, \
    traversal
from repro_torch.graph import csr
from repro_torch.sampling.spec import SamplerSpec

__all__ = ["Sampler", "make_sampler"]

_LATER = {
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
        g_rev = g_rev if g_rev is not None else csr.transpose(g)
        # Idempotent: an already-normalised graph passes through.
        self.g_rev = lt.normalized(g_rev) if spec.diffusion == "lt" \
            else g_rev

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

    # ------------------------------------------------------- rebinding
    def rebind(self, g: csr.Graph, g_rev: csr.Graph,
               touched_row_blocks=None) -> "Sampler":
        """Sampler for the delta-mutated ``(g, g_rev)`` pair under the same
        spec — the `repro_torch.stream` hook.  The default is a full
        rebuild (the tile backends rebuild their layouts, which every
        sampler over the new ``g_rev`` then shares through its cache); the
        dense sampler overrides it with a values-only fast path.  Either
        way the result equals a fresh `make_sampler` on the new graphs."""
        return make_sampler(g, self.spec, g_rev=g_rev)

    def _try_patch_fidx(self, g, g_rev, touched_row_blocks) -> bool:
        """Sparse-frontier fast path: when the delta kept the edge arrays'
        layout (tombstone, resurrection, LT renormalisation) and names its
        touched row blocks, patch this sampler's own frontier index (and
        the LT prefixes) in place.  True on success."""
        spec = self.spec
        if (spec.frontier != "sparse" or touched_row_blocks is None
                or getattr(self, "_fidx", None) is None):
            return False
        if spec.diffusion == "lt":
            g_rev = lt.normalized(g_rev)
        if not _same_edge_layout(self.g_rev, g_rev):
            return False
        self.graph = g
        self.g_rev = g_rev
        cb = None
        if spec.diffusion == "lt":
            cb = lt.selection_cum_before(g_rev)
            self._cb = torch.from_numpy(cb).to(g_rev.device)
        self._fidx = sparse.patch_frontier_index(
            self._fidx, g_rev, touched_row_blocks, cb=cb)
        return True


def _same_edge_layout(a: csr.Graph, b: csr.Graph) -> bool:
    """True when ``b`` kept ``a``'s edge-array layout (same lengths, same
    ``(src, dst)`` at every slot): the mutation changed probabilities only,
    so per-position structures (edge blocks, RNG edge ids) carry over."""
    return (a.num_edges == b.num_edges
            and a.padded_edges == b.padded_edges
            and torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst))


class DenseSampler(Sampler):
    """CSR edge-centric path, IC and LT.  ``spec.frontier == "sparse"``
    swaps the per-level edge sweep for the `core.sparse` edge-block
    compaction (bit-identical masks and work counters).  IC batches carry
    real edge-visit totals; LT carries the -1 sentinel."""

    def __init__(self, g, spec, *, g_rev=None):
        super().__init__(g, spec, g_rev=g_rev)
        self._cb = None
        self._fidx = None
        self._ladder = None

    def _lt_cb(self) -> torch.Tensor:
        if self._cb is None:
            self._cb = torch.from_numpy(
                lt.selection_cum_before(self.g_rev)).to(self.g_rev.device)
        return self._cb

    def _frontier_index(self) -> sparse.FrontierIndex:
        """The edge-block index (tile_rows follows ``spec.tile_size``, the
        ladder ``spec.frontier_capacity``), built on first use."""
        if self._fidx is None:
            cb = (self._lt_cb().cpu().numpy()
                  if self.spec.diffusion == "lt" else None)
            self._fidx = sparse.build_frontier_index(
                self.g_rev, tile_rows=self.spec.tile_size, cb=cb)
            self._ladder = sparse.bucket_ladder(self._fidx.num_blocks,
                                                self.spec.frontier_capacity)
        return self._fidx

    def sample(self, batch_index: int) -> rrr.RRRBatch:
        if self.spec.frontier == "sparse":
            return self.sample_many([batch_index])[0]
        return rrr.sample_batch(
            self.g_rev, self.spec.num_colors, self.spec.master_seed,
            int(batch_index), sort_starts=self.spec.sort_starts,
            max_levels=self.spec.max_iters, model=self.spec.diffusion)

    def sample_many(self, batch_indices) -> list[rrr.RRRBatch]:
        idx = [int(b) for b in batch_indices]
        if not idx:
            return []
        spec = self.spec
        starts = np.stack([self.batch_starts(b) for b in idx])
        seeds = rrr.batch_seeds(spec.master_seed, idx)
        if spec.frontier == "sparse":
            vis, fused, unfused = sparse.sparse_block(
                self._frontier_index(), starts, seeds, spec.num_colors,
                spec.max_iters, self._ladder, diffusion=spec.diffusion)
        elif spec.diffusion == "lt":
            vis = lt.run_fused_lt_block(self.g_rev, self._lt_cb(), starts,
                                        seeds, spec.num_colors,
                                        max_levels=spec.max_iters)
            fused = unfused = np.full(len(idx), -1)
        else:
            vis, fused, unfused = traversal.run_fused_block(
                self.g_rev, starts, seeds, spec.num_colors,
                max_levels=spec.max_iters)
        return [rrr.RRRBatch(vis[i], starts[i], b, int(fused[i]),
                             int(unfused[i]))
                for i, b in enumerate(idx)]

    def rebind(self, g, g_rev, touched_row_blocks=None):
        if self._try_patch_fidx(g, g_rev, touched_row_blocks):
            return self
        return make_sampler(g, self.spec, g_rev=g_rev)


class TiledSampler(Sampler):
    """Block-sparse tile path (``tiled`` and ``kernel`` alike, through the
    tile kernels).  The tile layout of the reversed graph — for LT, of the
    LT-normalised one, whose ``prob`` differs, with the selection-CDF
    prefixes beside it — is built once per graph object and shared by
    every sampler over it.  Requires a parallel-edge-free graph
    (``csr.dedupe``).  ``last_levels``, ``last_grid_steps`` (ladder rungs
    summed, the reference's counter) and ``last_active_tiles`` (the tiles
    the kernels walked) describe the last `sample` call."""

    def __init__(self, g, spec, *, g_rev=None):
        super().__init__(g, spec, g_rev=g_rev)
        try:
            # LT draws no per-edge hash: its layout skips the edge-id stack.
            self.tg_rev = tiles.cached(self.g_rev, spec.tile_size,
                                       edge_ids=spec.diffusion == "ic")
        except ValueError as e:
            raise ValueError(
                f"the {spec.backend!r} backend needs a dedupe-clean graph "
                "(build it with csr.dedupe or from_edges(..., dedupe=True)); "
                f"tiling failed with: {e}") from e
        self._cb_tiles = None
        if spec.diffusion == "lt":
            key = ("lt_cb_tiles", spec.tile_size)
            self._cb_tiles = self.g_rev.cache.get(key)
            if self._cb_tiles is None:
                self._cb_tiles = self.g_rev.cache[key] = tiles.lt_cb_tiles(
                    self.tg_rev, self.g_rev,
                    lt.selection_cum_before(self.g_rev))
        self._ladder = (sparse.bucket_ladder(self.tg_rev.num_tiles,
                                             spec.frontier_capacity)
                        if spec.frontier == "sparse" else None)
        self.last_levels = 0
        self.last_grid_steps = 0
        self.last_active_tiles = 0

    def sample(self, batch_index: int) -> rrr.RRRBatch:
        spec = self.spec
        starts = self.batch_starts(batch_index)
        seed = self.batch_seed(batch_index)
        work: dict = {}
        kw = dict(max_levels=spec.max_iters, frontier=spec.frontier,
                  ladder=self._ladder, work=work)
        if spec.diffusion == "lt":
            visited, levels, gs = tiled_traversal.run_fused_lt_tiled(
                self.tg_rev, self._cb_tiles, starts, spec.num_colors, seed,
                **kw)
        else:
            visited, levels, gs = tiled_traversal.run_fused_tiled(
                self.tg_rev, starts, spec.num_colors, seed, **kw)
        self.last_levels = levels
        self.last_grid_steps = gs
        self.last_active_tiles = sum(work["active_tiles"])
        return rrr.RRRBatch(visited, starts, int(batch_index), -1, -1)


def make_sampler(g: csr.Graph | None, spec: SamplerSpec, *,
                 g_rev: csr.Graph | None = None) -> Sampler:
    """Build the `Sampler` for ``spec`` on the graph's device.

    ``g_rev``: prebuilt transpose(g) (skips one reversal).  Cells of the
    reference's matrix that the port has not reached yet raise
    ``NotImplementedError`` naming their slice.
    """
    if spec.backend in _LATER:
        raise NotImplementedError(f"{spec.backend!r} is not ported yet: it "
                                  f"comes with {_LATER[spec.backend]}")
    if spec.backend in ("tiled", "kernel"):
        return TiledSampler(g, spec, g_rev=g_rev)
    return DenseSampler(g, spec, g_rev=g_rev)
