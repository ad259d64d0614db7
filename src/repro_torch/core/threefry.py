"""Threefry-2x32 root derivation, bit-compatible with ``jax.random``.

The reference draws each batch's roots with
``jax.random.randint(jax.random.key(s), (C,), 0, V, int32)``.  The port has
no jax, so this module repeats that computation in numpy uint32 for the
configuration the reference runs under: the ``threefry2x32`` PRNG with
``jax_threefry_partitionable=True`` and 64-bit mode off.

* ``key(s)`` is the pair ``(0, s mod 2**32)`` — jax first narrows the seed
  to 32 bits, so seeds ≥ 2**32 and negative seeds wrap;
* ``split`` is the fold-like split (counter pair ``(0, i)`` per subkey);
* random bits are ``x1 ^ x2`` of threefry over counters ``(0, i)``;
* ``randint`` draws two words per value and reduces them by a two-word
  modulus in wrapping uint32 arithmetic (jax's ``_randint``).
"""
from __future__ import annotations

import numpy as np

_M = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> np.ndarray:
    return np.asarray(x, np.uint64) & _M


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return ((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & _M


def threefry2x32(k1: int, k2: int, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function (20 rounds) on uint32 counters."""
    ks = [np.uint64(k1), np.uint64(k2),
          np.uint64((k1 ^ k2 ^ 0x1BD11BDA) & 0xFFFFFFFF)]
    x = [(_u32(x1) + ks[0]) & _M, (_u32(x2) + ks[1]) & _M]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M
    return x[0].astype(np.uint32), x[1].astype(np.uint32)


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` key data with 64-bit mode off."""
    return 0, int(seed) & 0xFFFFFFFF


def split(k: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (partitionable fold-like form)."""
    b1, b2 = threefry2x32(k[0], k[1], np.zeros(num), np.arange(num))
    return [(int(a), int(b)) for a, b in zip(b1, b2)]


def random_bits32(k: tuple[int, int], n: int) -> np.ndarray:
    """(n,) uint32 random words (partitionable ``_random_bits``)."""
    b1, b2 = threefry2x32(k[0], k[1], np.zeros(n), np.arange(n))
    return b1 ^ b2


def randint(k: tuple[int, int], n: int, minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval, int32)``."""
    k1, k2 = split(k)
    higher = random_bits32(k1, n).astype(np.uint64)
    lower = random_bits32(k2, n).astype(np.uint64)
    span = np.uint64(1 if maxval <= minval else (maxval - minval) & 0xFFFFFFFF)
    # 2**32 mod span as jax computes it: (2**16 mod span)**2 in WRAPPING
    # uint32, so the square is 0 whenever span > 2**16.
    multiplier = np.uint64(1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M) % span
    offset = (((higher % span) * multiplier) & _M) + (lower % span)
    offset = (offset & _M) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)
