"""Frozen copies of the two random draws the port's RNG contract fixes.

* The counter hash: one uint32 per ``(seed, level, edge id, colour)``
  through the murmur3 finalizer, folded as
  ``mix(h ^ (v + φ + (h << 6) + (h >> 2)))``, and its uniform: the top 24
  bits times 2**-24 (exact in float32).  Here on int64 tensors holding
  uint32 values, with every product split so it stays inside int64.
* A batch's roots: ``jax.random.randint(jax.random.key(s), (C,), 0, V)``
  under the threefry2x32 PRNG (partitionable form, 64-bit mode off), with
  ``s = master_seed·1,000,003 + batch index``, and its counter seed
  ``(master_seed·0x9E3779B9 + batch index·0x85EBCA6B) mod 2**32``.

Nothing here imports the program or jax.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul(x, m: int):
    """(x·m) mod 2**32 for x in [0, 2**32), never past 2**49."""
    return ((x * (m & 0xFFFF)) + (((x * (m >> 16)) & 0xFFFF) << 16)) & MASK


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul(x, _M1)
    x = x ^ (x >> 13)
    x = _mul(x, _M2)
    return x ^ (x >> 16)


def fold(h, v):
    """One counter step; ``h`` and ``v`` ints or int64 tensors in
    [0, 2**32)."""
    return _mix(h ^ ((v + _GOLDEN + ((h << 6) & MASK) + (h >> 2)) & MASK))


def level_prefix(seed: int, level: int) -> int:
    return fold(_mul(int(seed) & MASK, _GOLDEN), int(level) & MASK)


def uniform(h: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1) from the top 24 bits of a uint32."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def batch_seed(master_seed: int, batch_index: int) -> int:
    return (int(master_seed) * 0x9E3779B9 + int(batch_index) * 0x85EBCA6B) \
        & MASK


# ----------------------------------------------------------- threefry roots
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U = np.uint64(MASK)


def _threefry(k1: int, k2: int, n: int):
    """threefry2x32 (20 rounds) of the counters (0, i), i < n."""
    ks = [np.uint64(k1), np.uint64(k2), np.uint64((k1 ^ k2 ^ 0x1BD11BDA)
                                                  & MASK)]
    x0 = np.zeros(n, np.uint64) + ks[0]
    x1 = (np.arange(n, dtype=np.uint64) + ks[1]) & _U
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _U
            x1 = x0 ^ (((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r)))
                       & _U)
        x0 = (x0 + ks[(i + 1) % 3]) & _U
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _U
    return x0, x1


def _bits(key: tuple[int, int], n: int) -> np.ndarray:
    a, b = _threefry(key[0], key[1], n)
    return a ^ b


def roots(master_seed: int, batch_index: int, num_vertices: int,
          num_colors: int) -> np.ndarray:
    """(C,) int64 root vertices of a batch."""
    key = (0, (int(master_seed) * 1_000_003 + int(batch_index)) & MASK)
    a, b = _threefry(key[0], key[1], 2)
    higher = _bits((int(a[0]), int(b[0])), num_colors)
    lower = _bits((int(a[1]), int(b[1])), num_colors)
    span = np.uint64(max(num_vertices, 1))
    mult = np.uint64(1 << 16) % span
    mult = ((mult * mult) & _U) % span
    off = (((higher % span) * mult) & _U) + (lower % span)
    return ((off & _U) % span).astype(np.int64)
