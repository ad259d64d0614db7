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

* ``data_parallel`` — batch blocks split over ``spec.mesh_axis`` of a
               `distributed.comm.Mesh`: each rank traverses its contiguous
               slice by the dense backend, the masks are all-gathered;
* ``graph_parallel`` — the graph's destination rows split over
               ``spec.model_axis`` too (`graph.partition.ShardLayout`, built
               once per sampler from the CSR edges): each rank expands its
               slice of the batches on its row shard through the tile
               kernels (`distributed.traversal.graph_parallel_block`).

The mesh backends are SPMD: every rank of the mesh builds the same sampler
and calls it with the same batch indices; ``sample_many`` returns the whole
block's masks on every rank.

LT: the facade normalises the live-edge weights of the reversed graph
once per graph object, and uses a graph that already carries the invariant
as it is (`lt.normalized`).  ``rebind`` moves a sampler to a streamed
graph pair (`repro_torch.stream`).  Samplers run on their graph's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lt, rrr, sparse, tiled_traversal, tiles, \
    traversal
from repro_torch.graph import csr
from repro_torch.sampling.spec import SamplerSpec

__all__ = ["Sampler", "make_sampler"]


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
        return make_sampler(g, self.spec, getattr(self, "mesh", None),
                            g_rev=g_rev)

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


class _BlockSampler(Sampler):
    """The block protocol of the mesh backends: a subclass's
    ``_block(full, starts, seeds, keep)`` traverses the padded index list
    ``full`` (its roots and seeds beside it; the first ``keep`` are the
    real block) and returns its ``(B, Vp ≥ V, W)`` masks on every rank."""

    def __init__(self, g, spec, mesh, *, g_rev=None):
        super().__init__(g, spec, g_rev=g_rev)
        if mesh is None:
            raise ValueError(f"the {spec.backend} backend needs a mesh")
        for ax in self._axes(spec):
            if ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} not in mesh "
                                 f"{mesh.axis_names}")
        self.mesh = mesh

    @staticmethod
    def _axes(spec: SamplerSpec) -> tuple:
        return (spec.mesh_axis,)

    @property
    def data_shards(self) -> int:
        return self.mesh.axis_size(self.spec.mesh_axis)

    def _block_inputs(self, idx: list[int]):
        """(full, starts (Bp, C), seeds (Bp,)) for the block padded to a
        multiple of the data shards with repeats of the last index
        (identical work, result dropped)."""
        padded = -(-len(idx) // self.data_shards) * self.data_shards
        full = idx + [idx[-1]] * (padded - len(idx))
        starts = np.stack([self.batch_starts(b) for b in full])
        return full, starts, rrr.batch_seeds(self.spec.master_seed, full)

    def _block(self, full, starts, seeds, keep: int) -> torch.Tensor:
        raise NotImplementedError

    def sample_many(self, batch_indices) -> list[rrr.RRRBatch]:
        """The block's batches on every rank; edge-visit stats carry the
        -1 "not instrumented" sentinel, as the reference's mesh paths."""
        idx = [int(b) for b in batch_indices]
        if not idx:
            return []
        full, starts, seeds = self._block_inputs(idx)
        vis = self._block(full, starts, seeds, len(idx))[
            :, :self.g_rev.num_vertices]
        return [rrr.RRRBatch(vis[i], starts[i], b, -1, -1)
                for i, b in enumerate(idx)]

    def sample(self, batch_index: int) -> rrr.RRRBatch:
        return self.sample_many([int(batch_index)])[0]


class DataParallelSampler(_BlockSampler):
    """Batch blocks over ``spec.mesh_axis`` — IC and LT, either frontier.
    Each rank samples its contiguous slice of the padded block by the
    dense backend (no collective during a traversal), then one all-gather
    over the axis gives every rank the block."""

    def __init__(self, g, spec, mesh, *, g_rev=None):
        super().__init__(g, spec, mesh, g_rev=g_rev)
        self._local = DenseSampler(g, spec.replace(backend="dense"),
                                   g_rev=self.g_rev)

    def _block(self, full, starts, seeds, keep) -> torch.Tensor:
        from repro_torch.distributed.traversal import _data_slice
        mine = full[_data_slice(self.mesh, self.spec.mesh_axis, len(full))]
        vis = torch.stack([b.visited for b in self._local.sample_many(mine)])
        return self.mesh.all_gather(vis, self.spec.mesh_axis)

    def rebind(self, g, g_rev, touched_row_blocks=None):
        if self._local._try_patch_fidx(g, g_rev, touched_row_blocks):
            self.graph, self.g_rev = g, self._local.g_rev
            return self
        return make_sampler(g, self.spec, self.mesh, g_rev=g_rev)


class GraphParallelSampler(_BlockSampler):
    """Graph rows over ``spec.model_axis``, batch blocks over
    ``spec.mesh_axis``: the 2-D composition for graphs one device cannot
    hold.  IC and LT.

    The rank's row shard (`graph.partition.shard_layout` of the reversed
    graph's tile layout, straight from its CSR edges) and its slot list
    are built once; every block reuses them.  A rank holds only its
    shard's slot list and, during a block, its (batch slice × row slice)
    of the masks; an all-gather over each axis then gives every rank the
    block.  ``last_gather_words`` is the ``(B, max_iters)`` per-level
    exchange traffic of the last block (`distributed.traversal`)."""

    def __init__(self, g, spec, mesh, *, g_rev=None):
        super().__init__(g, spec, mesh, g_rev=g_rev)
        from repro_torch.graph import partition
        try:
            self.layout = partition.shard_layout(
                self.g_rev, spec.tile_size, mesh.axis_size(spec.model_axis),
                mesh.axis_index(spec.model_axis))
        except ValueError as e:
            raise ValueError(
                "the 'graph_parallel' backend needs a dedupe-clean graph "
                f"(build it with csr.dedupe); tiling failed with: {e}") from e
        self.slots = self._slot_list()
        self.last_gather_words = None

    @staticmethod
    def _axes(spec: SamplerSpec) -> tuple:
        return (spec.mesh_axis, spec.model_axis)

    def _slot_list(self) -> tiles.SlotList:
        """The shard's slot list of the current ``g_rev``: keys the edge
        ids (IC) or the selection-CDF prefixes' float32 bits (LT)."""
        prob = self.g_rev.edges_numpy()[2]
        if self.spec.diffusion == "lt":
            keys = np.asarray(lt.selection_cum_before(self.g_rev),
                              np.float32).view(np.int32)
        else:
            keys = np.arange(self.g_rev.num_edges, dtype=np.int32)
        return self.layout.slot_list(prob, keys, self.g_rev.device)

    def _block(self, full, starts, seeds, keep) -> torch.Tensor:
        from repro_torch.distributed.traversal import graph_parallel_block
        spec = self.spec
        vis, words = graph_parallel_block(
            self.layout, self.slots, self.mesh, starts, seeds,
            data_axis=spec.mesh_axis, model_axis=spec.model_axis,
            num_colors=spec.num_colors, max_levels=spec.max_iters,
            diffusion=spec.diffusion, frontier=spec.frontier,
            gather_capacity=spec.frontier_capacity)
        words = self.mesh.all_gather(torch.from_numpy(words), spec.mesh_axis)
        self.last_gather_words = words[:keep].numpy()
        rows = self.mesh.all_gather(vis.transpose(0, 1).contiguous(),
                                    spec.model_axis).transpose(0, 1)
        return self.mesh.all_gather(rows.contiguous(), spec.mesh_axis)

    def rebind(self, g, g_rev, touched_row_blocks=None):
        """A values-only delta keeps the shard layout and re-derives the
        slot list from the new probabilities (and LT prefixes); a
        structural one rebuilds the sampler."""
        g_rev_n = lt.normalized(g_rev) if self.spec.diffusion == "lt" \
            else g_rev
        if not _same_edge_layout(self.g_rev, g_rev_n):
            return make_sampler(g, self.spec, self.mesh, g_rev=g_rev)
        self.graph, self.g_rev = g, g_rev_n
        self.slots = self._slot_list()
        return self


def make_sampler(g: csr.Graph | None, spec: SamplerSpec, mesh=None, *,
                 g_rev: csr.Graph | None = None) -> Sampler:
    """Build the `Sampler` for ``spec`` on the graph's device.

    ``g_rev``: prebuilt transpose(g) (skips one reversal).  ``mesh`` (a
    `distributed.comm.Mesh`) is required by, and only used by, the
    ``data_parallel`` and ``graph_parallel`` backends.
    """
    if spec.backend == "graph_parallel":
        return GraphParallelSampler(g, spec, mesh, g_rev=g_rev)
    if spec.backend == "data_parallel":
        return DataParallelSampler(g, spec, mesh, g_rev=g_rev)
    if spec.backend in ("tiled", "kernel"):
        return TiledSampler(g, spec, g_rev=g_rev)
    return DenseSampler(g, spec, g_rev=g_rev)
