"""Single-token decode with static-shape caches (the reference's
``models/decode.py``, every block kind).

Caches are one entry per layer (the reference stacks them over its
scanned layers): GQA ``{k, v}`` each (B, Lmax, KVH, hd) and MLA the latent
``{c (B, Lmax, kv_lora_rank), k_rope (B, Lmax, rope_head_dim)}``, in the
working dtype; ``mamba`` ``{state (B, H, S, P) float32, conv (B, w-1,
d_inner + 2S)}``, O(1) in the context length; ``mamba_attn`` the pair
(mamba cache, the shared block's own ``{k, v}``).  `decode_step` writes
each layer's new entries into its cache in place and returns the same
list.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, common, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, MAMBA_KINDS, Block, _logits,
                                      embed_tokens, ffn_forward,
                                      layer_kinds)


def _layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 device):
    dt = common.dtype_of(cfg.dtype)
    if kind == "mamba":
        return ssm.init_mamba_cache(cfg, batch, device)
    if kind == "mamba_attn":
        return (ssm.init_mamba_cache(cfg, batch, device),
                attention.init_gqa_cache(cfg, batch, max_len, dt, device))
    init = (attention.init_mla_cache if cfg.attention == "mla"
            else attention.init_gqa_cache)
    return init(cfg, batch, max_len, dt, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device) -> list:
    """Zero caches, one per layer (module docstring): each ``mamba_attn``
    layer gets a KV cache of its own."""
    return [_layer_cache(kind, cfg, batch, max_len, device)
            for kind in layer_kinds(cfg)]


def _decode_one(p, cache, h, cur_len: int, cfg: ModelConfig,
                shared: Block | None = None):
    if p.kind in MAMBA_KINDS:
        mc = cache[0] if p.kind == "mamba_attn" else cache
        out, _ = ssm.mamba_decode(
            p.mamba, common.rms_norm(h, p.norm1, cfg.norm_eps), mc, cfg)
        h = h + out
        if p.kind == "mamba_attn":
            h, _ = _decode_one(shared, cache[1], h, cur_len, cfg)
        return h, cache
    dec = (attention.mla_decode if cfg.attention == "mla"
           else attention.gqa_decode)
    a_out, cache = dec(p.attn, common.rms_norm(h, p.norm1, cfg.norm_eps),
                       cache, cur_len, cfg)
    h = h + a_out
    out, _ = ffn_forward(p, common.rms_norm(h, p.norm2, cfg.norm_eps), cfg)
    return h + out, cache


def decode_step(params: LM, cfg: ModelConfig, caches: list,
                tokens: torch.Tensor, cur_len: int):
    """One decode step.  tokens: (B, 1) (audio: (B, K, 1)); cur_len: the
    write position (the new token attends positions ≤ cur_len).  Returns
    (logits (B, 1, V[, K]), caches)."""
    h = embed_tokens(params, cfg, tokens)
    for layer, cache in zip(params.layers, caches):
        h, _ = _decode_one(layer, cache, h, cur_len, cfg,
                           params.shared_attn)
    return _logits(params, cfg, h), caches
