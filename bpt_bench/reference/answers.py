"""Plain answers to influence queries over a pool of RRR-set batches.

The pool is ``(B, V, W)`` int32 words, colour c of batch b at bit c % 32
of word c // 32, θ = B·C sets.  σ(S) is n·|sets holding any vertex of
S|/θ; the marginal gain Δσ(v | X) is n·|sets holding v and no vertex of
X|/θ for every v.  Counts are exact integers (a SWAR popcount on int64
words below 2**32) and the estimate is the count times n, over θ, in
float64, in that order.  Nothing here imports the program.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64."""
    x = words.to(torch.int64) & MASK
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def tail_words(num_colors: int, words: int, device) -> torch.Tensor:
    """int64 words with a bit for each colour below ``num_colors``."""
    out = []
    for w in range(words):
        bits = min(32, max(0, num_colors - 32 * w))
        out.append((1 << bits) - 1)
    return torch.tensor(out, dtype=torch.int64, device=device)


def _union(pool: torch.Tensor, vertices) -> torch.Tensor:
    """(B, W) int64 OR of the rows of ``vertices``."""
    rows = pool[:, torch.as_tensor(list(vertices), dtype=torch.int64,
                                   device=pool.device)].to(torch.int64) & MASK
    out = torch.zeros_like(rows[:, 0])
    for j in range(rows.shape[1]):
        out |= rows[:, j]
    return out


def sigma_count(pool: torch.Tensor, seeds, num_colors: int) -> int:
    tail = tail_words(num_colors, pool.shape[-1], pool.device)
    return int(popcount(_union(pool, seeds) & tail).sum())


def marginal_counts(pool: torch.Tensor, exclude, num_colors: int,
                    block: int = 64) -> torch.Tensor:
    """(V,) int64 count of sets holding v and no vertex of ``exclude``."""
    tail = tail_words(num_colors, pool.shape[-1], pool.device)
    active = tail & ~_union(pool, exclude)              # (B, W)
    counts = torch.zeros(pool.shape[1], dtype=torch.int64,
                         device=pool.device)
    for b0 in range(0, pool.shape[0], block):
        part = (pool[b0:b0 + block].to(torch.int64) & MASK) \
            & active[b0:b0 + block, None, :]
        counts += popcount(part).sum((0, 2))
    return counts


def estimate(count, num_vertices: int, theta: int):
    """n·count/θ in float64 (a Python int or an int64 tensor)."""
    if isinstance(count, torch.Tensor):
        return count.to(torch.float64).cpu().numpy() * num_vertices / theta
    return float(count) * num_vertices / theta
