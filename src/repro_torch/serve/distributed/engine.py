"""Distributed influence-query engine (PyTorch port of
``repro.serve.distributed.engine``): local coverage, one collective.

The query API of `serve.influence.engine.QueryEngine` (so `MicroBatcher`
drives either), over a `ShardedSketchStore`, SPMD: every rank calls the
same queries in the same order and gets the same answers.

* each rank counts coverage over its own block of the pool with the
  coverage kernel (`kernels.ops.cover_counts` / ``cover_counts_multi``);
* one psum merges the partial counts — over ``data``, and when the store
  splits vertex rows over ``model``, each rank's ``(V/M,)`` counts are
  placed at its row offset in a zero ``(Vp,)`` vector first (``embed``),
  so a psum over both axes gives the exact merged counts;
* a seed's mask rows come back through one psum over ``model`` (``take``:
  the owner contributes the row, every other rank zeros — the integer sum
  is the row);
* greedy selection argmaxes the merged counts (first index on ties), so
  every rank picks the same seed with no further collective.  Vertex
  padding rows hold zero masks and never outscore a real vertex; pad slots
  get zero active masks and add nothing.

All reductions are integer, so the answers equal the one-device
`QueryEngine`'s on the same pool bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitmask
from repro_torch.kernels import ops
from repro_torch.serve.distributed.sharded_store import ShardedSketchStore
from repro_torch.serve.influence import engine as engine_lib


class DistributedQueryEngine:
    """Query programs over one rank's block of a sharded pool."""

    def __init__(self, store: ShardedSketchStore, *, query_slots: int = 8,
                 max_seeds: int = 8):
        self.store = store
        self.query_slots = query_slots
        self.max_seeds = max_seeds

    @property
    def _n(self) -> int:
        return self.store.graph.num_vertices

    @property
    def _theta(self) -> int:
        return self.store.num_samples

    @property
    def device(self) -> torch.device:
        return self.store.graph.device

    @property
    def mesh(self):
        return self.store.mesh

    def pad(self, seed_sets):
        return engine_lib.pad_queries(seed_sets, self.query_slots,
                                      self.max_seeds, self.device)

    # ------------------------------------------------------ row hooks
    def _all_axes(self) -> tuple:
        row = self.store.row_axis
        return (self.store.axis,) + ((row,) if row is not None else ())

    def _take(self, vis: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``(B_loc, n, W)`` mask rows at global ``rows`` (n,): with rows
        split, the owner contributes each, one psum over the row axis."""
        row_axis = self.store.row_axis
        if row_axis is None:
            return vis[:, rows]
        off, vloc = self.store.row_offset, self.store.rows_per_shard
        local = rows - off
        mine = (local >= 0) & (local < vloc)
        got = vis[:, local.clamp(0, vloc - 1)] * mine[None, :, None]
        return self.mesh.psum(got, row_axis)

    def _merge(self, counts: torch.Tensor) -> torch.Tensor:
        """Per-rank ``(..., V_loc)`` counts → the merged ``(..., Vp)``."""
        if self.store.row_axis is not None:
            vp = self.store.padded_vertices
            full = torch.zeros(counts.shape[:-1] + (vp,), dtype=counts.dtype,
                               device=counts.device)
            off = self.store.row_offset
            full[..., off:off + counts.shape[-1]] = counts
            counts = full
        return self.mesh.psum(counts, self._all_axes())

    def _initial_active(self) -> torch.Tensor:
        """``(Bp/S, W)`` all-uncovered mask of this rank's slots, pad slots
        zeroed."""
        st = self.store
        per, lo = st.slots_per_shard, st.slot_offset
        tail = bitmask.tail_mask_tensor(st.num_colors, self.device)
        valid = (torch.arange(lo, lo + per, device=self.device)
                 < len(st.batches))[:, None]
        return tail.expand(per, -1) * valid

    def _greedy(self, vis: torch.Tensor, active: torch.Tensor, k: int):
        """``k`` greedy picks from ``active``: (seeds (k,) int32 numpy,
        uncovered colour count over the whole pool)."""
        seeds = []
        for _ in range(k):
            counts = self._merge(ops.cover_counts(vis, active))
            sel = int(torch.argmax(counts))
            seeds.append(sel)
            row = self._take(vis, torch.tensor([sel], device=vis.device))
            active = active & ~row[:, 0]
        uncovered = self.mesh.psum(
            bitmask.popcount(active).sum(dtype=torch.int64).reshape(1),
            self.store.axis)
        return np.asarray(seeds, np.int32), int(uncovered)

    # -------------------------------------------------------------- top-k
    def top_k(self, k: int) -> tuple[np.ndarray, float]:
        """Greedy seed selection over the sharded pool: (seeds, σ̂)."""
        seeds, uncovered = self._greedy(self.store.visited_stack(),
                                        self._initial_active(), k)
        theta = self._theta
        return engine_lib._frozen(seeds), (theta - uncovered) / theta * self._n

    # --------------------------------------------------------------- σ(S)
    def _union(self, vis, seeds, mask) -> torch.Tensor:
        """``(B_loc, Q, W)`` OR of each query's seed rows."""
        q, s = seeds.shape
        rows = self._take(vis, seeds.reshape(-1))
        slots = torch.arange(q * s, device=vis.device).reshape(q, s)
        return engine_lib._union_rows(rows, slots, mask)

    def sigma_padded(self, seeds: torch.Tensor,
                     mask: torch.Tensor) -> np.ndarray:
        vis = self.store.visited_stack()
        tail = bitmask.tail_mask_tensor(self.store.num_colors, vis.device)
        covered = self._union(vis, seeds, mask) & tail
        counts = self.mesh.psum(
            bitmask.popcount(covered).sum((0, 2), dtype=torch.int32),
            self.store.axis)
        return engine_lib._frozen(counts.cpu().numpy().astype(np.float64)
                                  * self._n / self._theta)

    def sigma(self, seed_sets) -> np.ndarray:
        return self.sigma_padded(*self.pad(seed_sets))[:len(seed_sets)]

    # ----------------------------------------------------- marginal gains
    def marginal_padded(self, excl_seeds: torch.Tensor,
                        excl_mask: torch.Tensor) -> np.ndarray:
        vis = self.store.visited_stack()
        tail = bitmask.tail_mask_tensor(self.store.num_colors, vis.device)
        active = tail & ~self._union(vis, excl_seeds, excl_mask)
        counts = self._merge(ops.cover_counts_multi(vis, active))
        return engine_lib._frozen(
            counts[:, :self._n].cpu().numpy().astype(np.float64)
            * self._n / self._theta)

    def marginal_gains(self, exclude) -> np.ndarray:
        return self.marginal_padded(*self.pad([exclude]))[0]

    def best_extension(self, exclude, num: int = 1) -> np.ndarray:
        """Resume greedy selection after ``exclude`` — the exact
        marginal-gain argmax through the same greedy."""
        vis = self.store.visited_stack()
        active = self._initial_active()
        for s in exclude:
            row = self._take(vis, torch.tensor([int(s)], device=vis.device))
            active = active & ~row[:, 0]
        return self._greedy(vis, active, num)[0]
