"""Batched influence-query engine over a sketch pool (PyTorch port of
``repro.serve.influence.engine``).

Three query types, answered from the pool's columnar ``(B, V, W)`` stack:

* **top-k** — greedy max-k-cover (`core.imm.greedy_max_cover`, one
  `kernels.ops.cover_counts` launch per pick);
* **σ(S)** — the covered colours are the OR of the seeds' mask rows,
  σ(S) ≈ n · covered/θ;
* **marginal gain with exclusions** — per-vertex gain Δσ(v | X) against an
  active mask with X's colours stripped: one
  `kernels.ops.cover_counts_multi` launch per flush for every query slot,
  the batch sum fused into the kernel and the pool read once.

σ(S)/marginal queries are slotted: the batcher pads every flush into a
fixed ``(query_slots, max_seeds)`` shape, so concurrent callers share one
pass over the pool.  Each query program is a `repro_torch.tracing` span
(``engine.pad``, ``engine.top_k``, ``engine.sigma``, ``engine.marginal``;
the last two split into ``.count``, ``.read`` and ``.scale``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import bitmask, imm
from repro_torch.kernels import ops
from repro_torch.serve.influence import sketch_store


def _frozen(arr: np.ndarray) -> np.ndarray:
    """Engine results are shared across callers (cache hits, deduped
    tickets) — freeze them so one caller's in-place edit can't corrupt
    another's answer."""
    arr.flags.writeable = False
    return arr


def pad_queries(seed_sets, query_slots: int, max_seeds: int, device):
    """Pack ragged seed sets into (Q, S) index + validity-mask tensors."""
    if len(seed_sets) > query_slots:
        raise ValueError(f"{len(seed_sets)} queries > {query_slots} slots")
    seeds = np.zeros((query_slots, max_seeds), np.int64)
    mask = np.zeros((query_slots, max_seeds), bool)
    for q, s in enumerate(seed_sets):
        s = list(s)
        if len(s) > max_seeds:
            raise ValueError(f"seed set of {len(s)} > max_seeds={max_seeds}")
        seeds[q, :len(s)] = s
        mask[q, :len(s)] = True
    return (torch.from_numpy(seeds).to(device),
            torch.from_numpy(mask).to(device))


def _union_rows(visited: torch.Tensor, seeds: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """OR of the selected mask rows: (B, V, W) × (Q, S) → (B, Q, W)."""
    b, _, w = visited.shape
    q, s = seeds.shape
    rows = visited[:, seeds.reshape(-1)].reshape(b, q, s, w)
    rows = rows * mask[None, :, :, None]
    out = rows[:, :, 0]
    for j in range(1, s):
        out = out | rows[:, :, j]
    return out


def sigma_counts(visited, seeds, mask, num_colors: int) -> torch.Tensor:
    """Covered-colour counts per query slot: (Q,) int32."""
    tail = bitmask.tail_mask_tensor(num_colors, visited.device)
    covered = _union_rows(visited, seeds, mask) & tail
    return bitmask.popcount(covered).sum((0, 2), dtype=torch.int32)


def marginal_counts(visited, excl_seeds, excl_mask,
                    num_colors: int) -> torch.Tensor:
    """Per-vertex marginal-gain counts per exclusion slot: (Q, V) int32, the
    reference's ``lax.map`` over the slots in one pass over the pool."""
    tail = bitmask.tail_mask_tensor(num_colors, visited.device)
    active = tail & ~_union_rows(visited, excl_seeds, excl_mask)  # (B, Q, W)
    return ops.cover_counts_multi(visited, active)


class QueryEngine:
    """Static-shape query programs bound to one `SketchStore`."""

    def __init__(self, store: sketch_store.SketchStore, *,
                 query_slots: int = 8, max_seeds: int = 8):
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

    def pad(self, seed_sets):
        """``pad_queries`` at this engine's slot shape and device."""
        with tracing.span("engine.pad"):
            return pad_queries(seed_sets, self.query_slots, self.max_seeds,
                               self.device)

    def _estimates(self, counts: torch.Tensor, read: str,
                   scale: str) -> np.ndarray:
        """The counts read to the host (span ``read``: one blocking copy)
        and scaled to estimates (span ``scale``: float64, × n/θ)."""
        with tracing.span(read):
            counts = counts.cpu()
        with tracing.span(scale):
            return _frozen(counts.numpy().astype(np.float64)
                           * self._n / self._theta)

    # -------------------------------------------------------------- top-k
    def top_k(self, k: int) -> tuple[np.ndarray, float]:
        """Greedy seed selection over the pool: (seeds (k,), σ estimate)."""
        with tracing.span("engine.top_k"):
            seeds, cov = imm.greedy_max_cover(
                self.store.visited_stack(), k, self.store.num_colors)
            return _frozen(seeds), cov * self._n

    # --------------------------------------------------------------- σ(S)
    def sigma_padded(self, seeds: torch.Tensor,
                     mask: torch.Tensor) -> np.ndarray:
        """σ estimates for pre-padded (Q, S) queries."""
        with tracing.span("engine.sigma"):
            with tracing.span("engine.sigma.count"):
                counts = sigma_counts(self.store.visited_stack(), seeds,
                                      mask, self.store.num_colors)
            return self._estimates(counts, "engine.sigma.read",
                                   "engine.sigma.scale")

    def sigma(self, seed_sets) -> np.ndarray:
        """σ(S) for ≤ ``query_slots`` ragged seed sets."""
        return self.sigma_padded(*self.pad(seed_sets))[:len(seed_sets)]

    # ----------------------------------------------------- marginal gains
    def marginal_padded(self, excl_seeds: torch.Tensor,
                        excl_mask: torch.Tensor) -> np.ndarray:
        """(Q, V) per-vertex Δσ(v | X) for pre-padded exclusion sets."""
        with tracing.span("engine.marginal"):
            with tracing.span("engine.marginal.count"):
                counts = marginal_counts(self.store.visited_stack(),
                                         excl_seeds, excl_mask,
                                         self.store.num_colors)
            return self._estimates(counts, "engine.marginal.read",
                                   "engine.marginal.scale")

    def marginal_gains(self, exclude) -> np.ndarray:
        """(V,) per-vertex marginal influence gain given exclusions;
        vertices in ``exclude`` score ~0 (their colours are stripped)."""
        return self.marginal_padded(*self.pad([exclude]))[0]

    def best_extension(self, exclude, num: int = 1) -> np.ndarray:
        """Resume greedy selection after ``exclude`` — exact marginal-gain
        argmax, not a rescore."""
        visited = self.store.visited_stack()
        active = imm.initial_active(visited.shape[0], self.store.num_colors,
                                    visited.device)
        for s in exclude:
            active = active & ~visited[:, int(s), :]
        seeds, _, _ = imm.greedy_extend(visited, active, num)
        return seeds.cpu().numpy()
