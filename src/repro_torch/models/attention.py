"""Grouped-query attention of the LM substrate (llama / qwen / nemotron /
command-r / musicgen / phi3): the GQA part of the reference's
``models/attention.py``.

Prefill and decode both run the hand-written flash-attention kernel
(`kernels.ops.flash_attention`) where the reference runs its pure-XLA
blocked scan (``_run_q_blocks``, the twin of its Pallas kernel): prefill
causally with ``kv_offset=0``, decode with one query at
``kv_offset=cur_len`` over the padded cache, which masks the keys after
``cur_len`` as the reference's ``valid`` mask does.  Projections stay
``torch.matmul``, as the reference leaves them to XLA.

Parameters are the reference's layout — ``wq (d, h, hd)``,
``wk``/``wv (d, kvh, hd)``, ``wo (h, hd, d)``, biases ``(heads, hd)`` — in
an ``nn.ParameterDict`` per layer.  MLA (deepseek-v3) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

MLA_UNPORTED = ("MLA attention (models/attention.py mla_forward/mla_decode, "
                "deepseek-v3) is not ported yet: it comes with a later slice "
                "of the LM substrate (ROADMAP queue 1, item 15)")


# ------------------------------------------------------------------- init
def init_gqa(gen: torch.Generator, cfg: ModelConfig):
    """One layer's GQA weights on ``gen``'s device, drawn in the
    reference's order (wq, wk, wv, wo; zero biases)."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = common.dtype_of(cfg.dtype)
    p = {
        "wq": common.dense_init(gen, d, (h, hd), dt),
        "wk": common.dense_init(gen, d, (kvh, hd), dt),
        "wv": common.dense_init(gen, d, (kvh, hd), dt),
        "wo": common.dense_init(gen, h * hd, (d,), dt).reshape(h, hd, d),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kvh), ("bv", kvh)):
            p[name] = torch.zeros((heads, hd), dtype=dt, device=gen.device)
    return common.param_dict(p)


def _project(p, x, cfg: ModelConfig):
    """(q (B, L, H, hd), k, v (B, L, KVH, hd)) before RoPE."""
    b, L, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x2 = x.reshape(b * L, d)
    q = (x2 @ p["wq"].reshape(d, h * hd)).view(b, L, h, hd)
    k = (x2 @ p["wk"].reshape(d, kvh * hd)).view(b, L, kvh, hd)
    v = (x2 @ p["wv"].reshape(d, kvh * hd)).view(b, L, kvh, hd)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out_proj(p, out, cfg: ModelConfig):
    b, L, h, hd = out.shape
    return (out.reshape(b * L, h * hd) @ p["wo"].reshape(h * hd, -1)).view(
        b, L, -1)


# ----------------------------------------------------------------- GQA
def gqa_forward(p, x, positions, cfg: ModelConfig):
    """Full-sequence GQA (prefill).  x: (B, L, D) → (B, L, D), and returns
    (k, v) (B, L, KVH, hd) for cache construction.  Raises for a length
    the reference's blocked scan cannot take (``_run_q_blocks`` reshapes
    the queries into blocks of ``min(attn_block_q, L)`` rows); the kernel
    itself takes any length."""
    L = x.shape[1]
    if L < 1 or L % min(cfg.attn_block_q, L):
        raise ValueError(f"prompt length {L} is not a multiple of "
                         f"min(attn_block_q={cfg.attn_block_q}, L), which "
                         "the reference's prefill requires")
    q, k, v = _project(p, x, cfg)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, kv_offset=0)
    return _out_proj(p, out, cfg), (k, v)


def gqa_decode(p, x, cache, cur_len: int, cfg: ModelConfig):
    """One-token decode.  x: (B, 1, D); cache = {k, v}: (B, Lc, KVH, hd).

    The new key and value are written into the cache in place at
    ``cur_len`` (the reference returns an updated copy through
    ``dynamic_update_slice``); the same dict is returned."""
    b = x.shape[0]
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project(p, x, cfg)
    q = common.apply_rope(q, pos, cfg.rope_theta)
    k_new = common.apply_rope(k_new, pos, cfg.rope_theta)
    cache["k"][:, cur_len:cur_len + 1].copy_(k_new)
    cache["v"][:, cur_len:cur_len + 1].copy_(v_new)
    out = ops.flash_attention(q, cache["k"], cache["v"], causal=True,
                              kv_offset=cur_len)
    return _out_proj(p, out, cfg), cache


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
