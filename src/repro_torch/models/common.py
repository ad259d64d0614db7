"""Shared neural-net primitives of the LM substrate (the reference's
``models/common.py``).

Initialisers draw from an explicit ``torch.Generator`` (the reference's
``jax.random`` keys have no counterpart: the two give different numbers
from one seed, so tests carry the reference's weights across with
`repro_torch.convert.lm_params_from_jax`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ------------------------------------------------------------------ layers
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMS norm in float32, cast back to ``x.dtype``, then scaled — the
    reference's order (the cast comes before the multiply)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _relu2(x):
    return F.relu(x).square()


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":                       # jax.nn.gelu's default: tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":                      # nemotron: squared ReLU
        return _relu2
    raise ValueError(name)


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 numpy (cast to float32 by the caller,
    as the reference does: with θ = 500,000 at positions near 2,000 any
    other order drifts past 1e-5)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """`rope_freqs` as float32 on ``device``, copied there once (a copy per
    call would stall every decode step on the host)."""
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)
                            ).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., L, H, D) rotary over D (rotate halves, not interleaved
    pairs); positions: (..., L)."""
    freqs = _freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].float() * freqs            # (..., L, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., L, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- inits
def param_dict(tensors: dict) -> nn.ParameterDict:
    """One layer's weights as frozen parameters (serving takes no
    gradients)."""
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


def dense_init(gen: torch.Generator, in_dim: int, out_dims, dtype,
               scale: float | None = None) -> torch.Tensor:
    """Fan-in scaled normal on ``gen``'s device, drawn in float32 and cast
    to ``dtype``; out_dims may be a tuple for fused projections."""
    out_dims = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, *out_dims), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype):
    """Unit-normal embedding table on ``gen``'s device."""
    return torch.randn((vocab, dim), generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)
