"""Counter-based stateless RNG (PyTorch port of ``repro.core.rng``).

One uint32 word per ``(seed, level, edge_id, word_id)`` through the
murmur3 finalizer, exactly as the reference computes it, so every path of
the port draws the reference's Bernoulli realization bit for bit.  The
CUDA kernel (`csrc/fused_expand.cu`) repeats the same arithmetic in native
uint32.

Here words are int64 tensors holding uint32 values, masked to 32 bits after
every operation that can carry past bit 31.  Every function also accepts
plain Python ints, so the per-launch prefix ``fold(fold(seed·φ, level))``
is computed once on the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitmask import MASK32, i32, u32

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(x, m: int):
    """``(x * m) mod 2**32`` for ``x`` in ``[0, 2**32)`` without leaving the
    int64 range: the constant is split into 16-bit halves."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(x):
    """murmur3 fmix32 finalizer — full-avalanche 32-bit mixer."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def _fold(h, v):
    """One counter step: ``mix(h ^ (v + φ + (h << 6) + (h >> 2)))``."""
    return _mix32(h ^ ((v + _GOLDEN + ((h << 6) & MASK32) + (h >> 2))
                       & MASK32))


def _as_u32(x):
    if isinstance(x, torch.Tensor):
        return u32(x) if x.dtype == torch.int32 else x.to(torch.int64) & MASK32
    return int(x) & MASK32


def level_prefix(seed, level):
    """The hash state after ``seed`` and ``level`` — shared by every edge
    and colour of one traversal level."""
    return _fold(_mul32(_as_u32(seed), _GOLDEN), _as_u32(level))


def hash_u32(seed, level, edge_id, word_id):
    """Hash 4 counters to one uint32 value (int64 tensor or int;
    vectorized over any of them)."""
    h = _fold(level_prefix(seed, level), _as_u32(edge_id))
    return _fold(h, _as_u32(word_id))


def uniform_from_u32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values → float32 uniform in [0, 1) from the top 24 bits (exact:
    a 24-bit integer times 2**-24)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def bernoulli_word(seed, level, edge_id: torch.Tensor, word_id,
                   prob: torch.Tensor, lanes: int = 32) -> torch.Tensor:
    """Packed int32 word of ``lanes`` independent Bernoulli(prob) bits: bit
    ``c`` is the draw for colour ``word_id*32 + c`` of ``edge_id``."""
    lane = torch.arange(lanes, dtype=torch.int64, device=edge_id.device)
    bits = hash_u32(seed, level, edge_id[..., None],
                    _as_u32(word_id) * 32 + lane)
    draws = uniform_from_u32(bits) < prob.to(torch.float32)[..., None]
    return pack_bool_word(draws)


def pack_bool_word(bits_bool: torch.Tensor) -> torch.Tensor:
    """Pack the trailing axis of ≤32 bools into an int32 bit pattern."""
    lanes = bits_bool.shape[-1]
    weights = torch.ones(lanes, dtype=torch.int64, device=bits_bool.device) \
        << torch.arange(lanes, device=bits_bool.device)
    return i32((bits_bool.to(torch.int64) * weights).sum(-1))
