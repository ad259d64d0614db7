"""Mamba2 / SSD (state-space duality) sequence mixer (the reference's
``models/ssm.py``), in plain PyTorch, as the reference computes it in
``jnp`` and never sends it to a Pallas kernel.

Chunked SSD (Dao & Gu 2024): the sequence splits into chunks of
``min(cfg.ssm_chunk, L)``; within a chunk the recurrence is a masked
attention-like product, across chunks a loop over the chunks carries the
(H, S, P) state.  Decode is the O(1) recurrence on a cached state and a
(w-1)-step conv tail, independent of the context length.

Layout: d_inner = expand·d_model, H = ``cfg.ssm_heads`` heads of P =
d_inner / H, one B/C group, a scalar decay per head.

Precision follows the reference: ``a_log``, ``d_skip`` and ``dt_bias`` are
float32 parameters in every dtype; dt's softplus, A, the chunk tensors,
the state and the gate ``silu(z)`` are float32; the projections, the conv
and the norm weight run in the working dtype, and the mixer's output is
cast back to it before the norm.  Products are float32 without TF32 when
the caller leaves TF32 off (PyTorch's default for matmuls).

Within a chunk, ``decay = exp(cum_i - cum_j)`` overflows float32 for
j > i over a long chunk (the exponent passes 88); the reference hides the
``inf`` behind ``jnp.where``.  Here the exponent is masked to ``-inf``
before ``exp``, so those entries are exactly 0 and no ``inf`` exists.
The decay tensor is built in (B, nc, H, i, j) order, so the intra-chunk
product is one batched matmul without a transposed copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import fsdp
from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    """One layer's mixer weights on ``gen``'s device, drawn in the
    reference's order (in_proj, conv, out_proj; ``a_log`` 0, ``d_skip`` 1,
    ``dt_bias`` 0 in float32, ``norm`` 1)."""
    d, di, s, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = common.dtype_of(cfg.dtype)
    dev = gen.device
    in_proj = common.dense_init(gen, d, (2 * di + 2 * s + h,), dt)
    conv = common.randn(gen, (cfg.conv_width, di + 2 * s)).mul_(0.1).to(dt)
    return common.param_dict({
        "in_proj": in_proj,
        "conv": conv,
        "a_log": torch.zeros(h, dtype=torch.float32, device=dev),
        "d_skip": torch.ones(h, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=dev),
        "norm": torch.ones(di, dtype=dt, device=dev),
        "out_proj": common.dense_init(gen, di, (d,), dt),
    })


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """The in-projection's (z, xBC, dt) columns."""
    di, s = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * s],
            zxbcdt[..., 2 * di + 2 * s:])


def _causal_conv(xbc: torch.Tensor, conv: torch.Tensor, cfg: ModelConfig,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv of width w over the channels, then silu.
    tail: (B, w-1, C) from a previous segment (decode or a continued
    prefill).  Returns (out, the new tail (B, w-1, C), a tensor of its
    own)."""
    w = cfg.conv_width
    if tail is None:
        tail = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[-1]))
    padded = torch.cat([tail, xbc], 1)                     # (B, L+w-1, C)
    L = xbc.shape[1]
    out = padded[:, 0:L] * conv[0]
    for i in range(1, w):                                  # the reference's
        out = out + padded[:, i:i + L] * conv[i]           # sum order
    return F.silu(out), padded[:, -(w - 1):].clone()


def _in_proj(p, x: torch.Tensor) -> torch.Tensor:
    b, L, d = x.shape
    return (x.reshape(b * L, d) @ p["in_proj"]).view(b, L, -1)


def _gate_norm_out(p, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """rms_norm(y · silu(z) in float32, cast to x's dtype) @ out_proj."""
    b, L, di = y.shape
    g = common.rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm"],
                        cfg.norm_eps)
    return (g.reshape(b * L, di) @ p["out_proj"]).view(b, L, -1)


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, conv_tail=None,
                  init_state=None):
    """x: (B, L, D) → ((B, L, D), (final state (B, H, S, P) float32, conv
    tail (B, w-1, d_inner + 2S))) for caching.  ``conv_tail`` and
    ``init_state`` continue a previous segment.  Raises `ValueError` for a
    length the reference refuses (L not a multiple of ``min(ssm_chunk,
    L)``); nothing is padded."""
    b, L, _ = x.shape
    di, S, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    if L < 1 or L % min(cfg.ssm_chunk, L):
        raise ValueError(f"sequence length {L} is not a multiple of "
                         f"min(ssm_chunk={cfg.ssm_chunk}, L), which the "
                         "reference's chunked SSD requires")
    cs = min(cfg.ssm_chunk, L)
    nc = L // cs

    z, xbc, dt = _split(_in_proj(p, x), cfg)
    xbc, tail = _causal_conv(xbc, p["conv"], cfg, conv_tail)
    xs, Bc, Cc = xbc[..., :di], xbc[..., di:di + S], xbc[..., di + S:]
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, L, H)
    A = -torch.exp(p["a_log"])                                 # (H,)

    xh = xs.reshape(b, nc, cs, H, P).float()
    Bcc = Bc.reshape(b, nc, cs, S).float()
    Ccc = Cc.reshape(b, nc, cs, S).float()
    dtc = dt.view(b, nc, cs, H)
    cum = torch.cumsum(dtc * A, dim=2)                         # (B,nc,cs,H)
    xh_t = xh.permute(0, 1, 3, 2, 4)                           # (B,nc,H,j,P)

    # ---- intra-chunk (masked attention-like), in (B, nc, H, i, j) ----
    cb = Ccc @ Bcc.transpose(-1, -2)                           # (B,nc,i,j)
    cum_t = cum.transpose(2, 3)                                # (B,nc,H,cs)
    scores = cum_t[..., :, None] - cum_t[..., None, :]         # cum_i - cum_j
    upper = torch.ones((cs, cs), dtype=torch.bool,
                       device=x.device).triu_(1)
    scores.masked_fill_(upper, float("-inf"))
    if torch.is_grad_enabled() and (scores.requires_grad or cb.requires_grad
                                    or dtc.requires_grad):
        # Out of place: exp's backward reads its result.
        scores = scores.exp() * cb[:, :, None] \
            * dtc.transpose(2, 3)[..., None, :]
    else:                                                      # serving
        scores.exp_().mul_(cb[:, :, None]).mul_(
            dtc.transpose(2, 3)[..., None, :])                 # decay; 0 above
    y = scores @ xh_t                                          # (B,nc,H,i,P)
    del scores, cb

    # ---- chunk states + inter-chunk recurrence ----
    w_j = torch.exp(cum[:, :, -1:, :] - cum) * dtc             # (B,nc,cs,H)
    wx = (w_j[..., None] * xh).view(b, nc, cs, H * P)
    state_c = (Bcc.transpose(-1, -2) @ wx).view(b, nc, S, H, P) \
        .permute(0, 1, 3, 2, 4)                                # (B,nc,H,S,P)
    del wx
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B, nc, H)
    s = (init_state if init_state is not None
         else x.new_zeros((b, H, S, P), dtype=torch.float32))
    s_before = []
    for c in range(nc):                                        # emit BEFORE
        s_before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + state_c[:, c]
    s_before = torch.stack(s_before, 1)                        # (B,nc,H,S,P)

    y_inter = Ccc[:, :, None] @ s_before                       # (B,nc,H,i,P)
    y.add_(y_inter.mul_(torch.exp(cum).transpose(2, 3)[..., None]))
    del y_inter, s_before
    y = y.permute(0, 1, 3, 2, 4).reshape(b, L, H, P)
    y = y + p["d_skip"][None, None, :, None] * xs.reshape(b, L, H, P).float()
    return _gate_norm_out(p, y.reshape(b, L, di), z, x, cfg), (s, tail)


def mamba_decode(p, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 split=None):
    """One-token decode.  x: (B, 1, D); cache {state (B, H, S, P) float32,
    conv (B, w-1, d_inner + 2S)}, both updated in place; returns (out
    (B, 1, D), the same cache).

    With ``split`` (mesh, state split, conv split) the cache is this
    rank's slice on a mesh (`models.decode`): a split conv tail holds the
    rank's block of channels, which it convolves before the conv output
    is all-gathered over ``model``; a split state holds the rank's block
    of heads, which it updates before their outputs are all-gathered."""
    b = x.shape[0]
    di, S, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    mesh, split_state, split_conv = split or (None, False, False)
    z, xbc, dt = _split(_in_proj(p, x), cfg)
    if split_conv:
        n = cache["conv"].shape[-1]
        lo = mesh.axis_index("model") * n
        xbc, tail = _causal_conv(xbc[..., lo:lo + n], p["conv"][:, lo:lo + n],
                                 cfg, cache["conv"])
        cache["conv"].copy_(tail)
        xbc = fsdp.gather_dim(xbc, -1, "model", mesh)
    else:
        xbc, tail = _causal_conv(xbc, p["conv"], cfg, cache["conv"])
        cache["conv"].copy_(tail)
    xbc = xbc[:, 0]
    xs, Bc, Cc = xbc[:, :di], xbc[:, di:di + S], xbc[:, di + S:]
    heads = slice(0, H)
    if split_state:
        hl = cache["state"].shape[1]
        heads = slice(mesh.axis_index("model") * hl,
                      (mesh.axis_index("model") + 1) * hl)
    dt = F.softplus(dt[:, 0, heads].float() + p["dt_bias"][heads])  # (B, h)
    A = -torch.exp(p["a_log"][heads])
    dA = torch.exp(dt * A)                                     # (B, h)
    xh = xs.reshape(b, H, P)[:, heads].float()
    upd = Bc.float()[:, None, :, None] * (dt[..., None] * xh)[:, :, None]
    state = cache["state"]
    state.mul_(dA[..., None, None]).add_(upd)                  # (B,h,S,P)
    y = (Cc.float()[:, None, None, :] @ state)[:, :, 0]        # (B, h, P)
    y = y + p["d_skip"][heads][None, :, None] * xh
    if split_state:
        y = mesh.all_gather(y.transpose(0, 1).contiguous(), "model") \
            .transpose(0, 1)                                   # (B, H, P)
    return _gate_norm_out(p, y.reshape(b, 1, di), z, x, cfg), cache


def mamba_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    """The decode cache's leaves as ``{name: (shape, dtype)}``: ``state``
    (B, H, S, P) float32, ``conv`` (B, w-1, d_inner + 2S) in the working
    dtype."""
    di, S, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"state": ((batch, H, S, di // H), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, di + 2 * S),
                     common.dtype_of(cfg.dtype))}


def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """Zero decode cache (`mamba_cache_shapes`)."""
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in mamba_cache_shapes(cfg, batch).items()}
