"""The work a kernel call needs, counted from its inputs: operations and
HBM bytes, and the least time one H100 could take for them.

A frozen copy of the port's ``kernels.work`` formulas, with the tile
kernel's operations counted from what a batch's own BFS made live rather
than from the most a level could need.

* ``fused_expand``, one IC level: the slot list (the tile pointers and, a
  listed edge, its source row, head row, probability and edge id: 16 B),
  the frontier and the visited rows read once, the new frontier written
  once.  A batch's operations are its live draws: a (vertex, colour) pair
  sits in exactly one level's frontier, so the draws are Σ over edges of
  the popcount of the batch's visited row at the edge's tail, each
  ``OPS_PER_DRAW``, plus one ``OPS_PER_EDGE_FOLD`` for each edge whose
  tail holds any colour.  (This counts every pair whose tail held the
  colour, also where the head already held it and no draw is needed: an
  upper count of the draws.)
* ``cover_counts`` with Q masks over a (B, V, W) pool: each word read
  once, the masks once, the (Q, V) counts written once; an and, a
  popcount and an add per (word, mask).
"""
from __future__ import annotations

import torch

from bpt_bench.reference import answers

OPS_PER_EDGE_FOLD = 14
OPS_PER_DRAW = 18

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_OPS_PER_S = 67e12          # int32 taken at the float32 CUDA-core rate


def bound_s(ops: float, nbytes: float) -> float:
    """The least time for the work: the larger of its two bounds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def expand_level_bytes(num_edges: int, num_tiles: int, rows: int,
                       words: int) -> int:
    """One level's bytes: slot list, frontier, visited, output."""
    return (num_tiles + 1) * 4 + 16 * num_edges + 3 * rows * words * 4


def row_popcounts(visited: torch.Tensor) -> torch.Tensor:
    """(V,) int64 colours held by each row of int32 ``(V, W)`` words."""
    return answers.popcount(visited).sum(-1)


def expand_batch_ops(visited: torch.Tensor, out_degree: torch.Tensor
                     ) -> float:
    """A batch's live draws and folds, as operations: ``visited`` its
    final int32 ``(V, W)`` mask, ``out_degree`` the (V,) edges out of each
    vertex of the reversed graph."""
    held = row_popcounts(visited[:out_degree.shape[0]])
    deg = out_degree.to(held.device, torch.int64)
    draws = int((deg * held).sum())
    folds = int(deg[held > 0].sum())
    return float(draws * OPS_PER_DRAW + folds * OPS_PER_EDGE_FOLD)


def cover_counts(batches: int, vertices: int, words: int,
                 masks: int) -> tuple[float, float]:
    """(operations, bytes) of one ``cover_counts`` launch."""
    b, v, w, q = batches, vertices, words, masks
    return (float(3 * b * v * w * q),
            float((b * v * w + b * q * w + q * v) * 4))
