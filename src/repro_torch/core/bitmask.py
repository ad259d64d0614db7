"""Packed colour-bitmask utilities (PyTorch port of ``repro.core.bitmask``).

Masks are ``(..., W)`` tensors with ``W = ceil(colors / 32)`` words, colour
``c`` at bit ``c % 32`` of word ``c // 32`` — the reference's layout.  A word
is stored as a ``torch.int32`` holding the uint32 bit pattern, because
PyTorch implements few operators for ``torch.uint32``.  Bitwise ``& | ^ ~``
are the same on either view; shifts and arithmetic go through ``u32``
(int64 in ``[0, 2**32)``) and back through ``i32``, which wraps explicitly.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF
_SIGN = 0x80000000


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 values in ``[0, 2**32)``."""
    return words.to(torch.int64) & MASK32


def i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` → int32 bit patterns (explicit wrap:
    flipping bit 31 and subtracting 2**31 maps ``[2**31, 2**32)`` onto the
    negative int32 range without an out-of-range narrowing)."""
    return ((values ^ _SIGN) - _SIGN).to(torch.int32)


def num_words(num_colors: int) -> int:
    return -(-num_colors // WORD_BITS)


def color_tail_mask(num_colors: int) -> np.ndarray:
    """(W,) uint32 mask that zeroes bits past ``num_colors`` in the last word."""
    w = num_words(num_colors)
    out = np.full((w,), 0xFFFFFFFF, dtype=np.uint32)
    rem = num_colors % WORD_BITS
    if rem:
        out[-1] = np.uint32((1 << rem) - 1)
    return out


def tail_mask_tensor(num_colors: int, device) -> torch.Tensor:
    """``color_tail_mask`` as an int32 bit-pattern tensor on ``device``."""
    return torch.from_numpy(
        color_tail_mask(num_colors).view(np.int32).copy()).to(device)


def make_mask(num_items: int, num_colors: int, device) -> torch.Tensor:
    """All-zeros packed mask of shape (num_items, W)."""
    return torch.zeros((num_items, num_words(num_colors)), dtype=torch.int32,
                       device=device)


def set_color(mask: torch.Tensor, item: torch.Tensor,
              color: torch.Tensor) -> torch.Tensor:
    """Set bit ``color`` of row ``item`` (vectorized over both; duplicate
    items — several colours starting at one vertex — are OR-combined)."""
    item = torch.as_tensor(item, device=mask.device).to(torch.int64)
    color = torch.as_tensor(color, device=mask.device).to(torch.int64)
    word = color // WORD_BITS
    bit = i32(torch.ones_like(color) << (color % WORD_BITS))
    flat = scatter_or_words(torch.zeros_like(mask), item, word, bit)
    return mask | flat


def scatter_or_words(dst: torch.Tensor, rows: torch.Tensor,
                     words: torch.Tensor, values: torch.Tensor,
                     unique: bool = False) -> torch.Tensor:
    """``dst[rows, words] |= values`` with duplicate-index OR semantics.

    PyTorch has no OR-scatter and ``index_put_`` keeps one of several
    duplicate writes, so each contribution is unpacked to 32 uint8 lanes,
    combined with ``scatter_reduce_(..., "amax")`` (per-bit OR) and
    repacked.  ``unique=True`` is the packed path for callers whose
    ``(rows[i], words[i])`` targets are all distinct (the distributed
    sparse frontier's reconstruction): with no duplicate to combine, a
    gather-OR-scatter of whole words is exact at 1× the index traffic.
    """
    rows = torch.as_tensor(rows, device=dst.device).to(torch.int64)
    words = torch.as_tensor(words, device=dst.device).to(torch.int64)
    if unique:
        out = dst.clone()
        out[rows, words] = dst[rows, words] | values
        return out
    w = dst.shape[-1]
    lanes = unpack_bits(values).to(torch.uint8).reshape(-1, WORD_BITS)
    flat = (rows * w + words).reshape(-1, 1).expand(-1, WORD_BITS)
    dst_lanes = unpack_bits(dst).to(torch.uint8).reshape(-1, WORD_BITS)
    dst_lanes.scatter_reduce_(0, flat, lanes, "amax")
    return pack_bits(dst_lanes.reshape(*dst.shape, WORD_BITS))


def unpack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 → (..., W, 32) bool (the ``& 1`` makes the arithmetic
    shift of a negative word harmless)."""
    shifts = torch.arange(WORD_BITS, device=mask.device, dtype=torch.int32)
    return ((mask[..., None] >> shifts) & 1).to(torch.bool)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., W, 32) bool → (..., W) int32 bit patterns."""
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=bits.device) \
        << torch.arange(WORD_BITS, device=bits.device)
    return i32((bits.to(torch.int64) * weights).sum(-1))


def popcount(mask: torch.Tensor) -> torch.Tensor:
    """Per-word population count (SWAR on the uint32 values) → int32."""
    x = u32(mask)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & MASK32) >> 24).to(torch.int32)


def any_set_flag(mask: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor on the mask's device: any bit set (launched, not
    read)."""
    return torch.any(mask != 0)


def any_set(mask: torch.Tensor) -> bool:
    """True if any bit is set anywhere in the mask (one host sync)."""
    return bool(any_set_flag(mask))


def count_colors(mask: torch.Tensor) -> torch.Tensor:
    """Total set bits per row: (R, W) → (R,) int32."""
    return popcount(mask).sum(-1, dtype=torch.int32)
