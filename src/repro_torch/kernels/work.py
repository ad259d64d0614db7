"""The work of one kernel call from its arguments' shapes: (operations,
HBM bytes), by the formulas of the bound column of PERF.md §6 — each
input read once, each output written once, and for flash attention
4·D operations per visible (query, key) pair forward and 10·D backward
(two products and five, respectively).  The meta branches of
`kernels.ops` report these to the dry-run's counter
(`launch.cost_analysis`).

A tile kernel's work depends on its data (the live frontier rows, the
colours drawn), and a meta tensor has none: for those the count is every
listed slot live and every colour drawn, the most a level can need.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa

# Integer operations of the counter hash (core/rng.py): one fold is
# 2 shifts + 3 adds + 1 xor, then mix32 is 3 shift-xor pairs + 2
# multiplies; a colour draw adds shift, convert, scale and compare.  A
# quantised draw: one fold (14) serves four colours, each of which adds a
# shift, a mask and a compare; counted as 20 a hash.
OPS_PER_EDGE_FOLD = 14
OPS_PER_DRAW = 18
OPS_PER_Q_HASH = 20


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def slot_expand(slots, frontier: torch.Tensor, visited: torch.Tensor,
                gate: str, u: torch.Tensor | None = None
                ) -> tuple[float, float]:
    """One level of a slot-list kernel (``gate`` ``"ic"``, ``"q"`` or
    ``"lt"``) over every listed slot: the list, the frontier and visited
    rows read, the new frontier written; per slot one counter fold and a
    draw per colour (IC), a quantised hash per four colours, or LT's
    three operations per (slot, colour)."""
    n = slots.num_entries
    colours = 32 * frontier.shape[-1]
    nbytes = (slots.nbytes + _nbytes(frontier, visited, u)
              + _nbytes(visited))
    if gate == "ic":
        ops = n * OPS_PER_EDGE_FOLD + n * colours * OPS_PER_DRAW
    elif gate == "q":
        ops = n * -(-colours // 4) * OPS_PER_Q_HASH
    else:
        ops = n + 3 * n * colours
    return float(ops), float(nbytes)


def cover_counts(visited: torch.Tensor, masks: int) -> tuple[float, float]:
    """``cover_counts`` with ``masks`` active masks a batch over (B, V, W)
    ``visited``: each word read once, the masks once, the counts written
    once; an and, a popcount and an add per (word, mask)."""
    b, v, w = visited.shape
    return (float(3 * b * v * w * masks),
            float((b * v * w + b * masks * w + masks * v) * 4))


def visible_pairs(lq: int, lk: int, causal: bool, kv_offset: int) -> int:
    """(query, key) pairs a call attends: query i sees keys up to ``i +
    kv_offset`` under ``causal`` (none below 0), every key otherwise."""
    if not causal:
        return lq * lk
    return int(np.clip(np.arange(lq, dtype=np.int64) + kv_offset + 1, 0,
                       lk).sum())


def flash_forward(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  kv_offset: int, lse: bool) -> tuple[float, float]:
    """The forward (any route) of q (B, Lq, H, D) over k, v (B, Lk, KVH,
    D): 4·D operations a visible pair; q and the output, and the keys and
    values each query row can see (a decode row reads only its visible
    keys), and the float32 log-sum-exp when written."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    pairs = visible_pairs(lq, lk, causal, kv_offset)
    read = lk if lq > 1 else visible_pairs(1, lk, causal, kv_offset)
    nbytes = q.element_size() * (2 * b * lq * h * d + 2 * b * read * kvh * d)
    return (float(4 * b * h * pairs * d),
            float(nbytes + (4 * b * h * lq if lse else 0)))


def flash_backward(q: torch.Tensor, k: torch.Tensor, causal: bool
                   ) -> tuple[float, float]:
    """The gradient of q, o, do (B, L, H, D) and k, v (B, L, KVH, D), all
    its launches: 10·D operations a visible pair (five products); q, o, do
    and dq, and k, v, dk and dv, each once."""
    parts = flash_backward_launches(q, k, causal)
    return (float(sum(p[0] for p in parts)),
            float(sum(p[1] for p in parts)))


def flash_backward_launches(q: torch.Tensor, k: torch.Tensor, causal: bool
                            ) -> list[tuple[float, float]]:
    """`flash_backward`'s work shared among its launches, one (operations,
    bytes) a launch (`flash_attention.bwd_launches`): the dq launch s, dP
    and dS·K (6·D a visible pair), reading q, k, v, o and do and writing
    dq; then dk and dv together (4·D, writing both), or at a head dim of
    `flash_attention.SPLIT_DKDV_HEAD_DIMS` dv (Pᵀ·do, 2·D) and dk (dSᵀ·q,
    2·D), each writing its own.  Each input counts once, in the first
    launch that reads it."""
    b, L, h, d = q.shape
    kvh = k.shape[2]
    pairs = b * h * visible_pairs(L, L, causal, 0)
    e = q.element_size()
    q_bytes, kv_bytes = e * b * L * h * d, e * b * L * kvh * d
    dq = (float(6 * pairs * d), float(4 * q_bytes + 2 * kv_bytes))
    if d in fa.SPLIT_DKDV_HEAD_DIMS:
        return [dq, (float(2 * pairs * d), float(kv_bytes)),
                (float(2 * pairs * d), float(kv_bytes))]
    return [dq, (float(4 * pairs * d), float(2 * kv_bytes))]
