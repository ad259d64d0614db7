"""Single-token decode with static-shape caches (the reference's
``models/decode.py``, dense and MoE blocks).

Caches are one dict per layer, in the working dtype: GQA ``{k, v}`` each
(B, Lmax, KVH, hd); MLA the latent ``{c (B, Lmax, kv_lora_rank), k_rope
(B, Lmax, rope_head_dim)}`` (the reference stacks them over its scanned
layers).  `decode_step` writes each layer's new entries into its cache in
place and returns the same list.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, common
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, Block, _logits, check_supported,
                                      embed_tokens, ffn_forward)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device) -> list[dict]:
    check_supported(cfg)
    dt = common.dtype_of(cfg.dtype)
    init = (attention.init_mla_cache if cfg.attention == "mla"
            else attention.init_gqa_cache)
    return [init(cfg, batch, max_len, dt, device)
            for _ in range(cfg.num_layers)]


def _decode_one(p: Block, cache: dict, h, cur_len: int, cfg: ModelConfig):
    dec = (attention.mla_decode if cfg.attention == "mla"
           else attention.gqa_decode)
    a_out, cache = dec(p.attn, common.rms_norm(h, p.norm1, cfg.norm_eps),
                       cache, cur_len, cfg)
    h = h + a_out
    out, _ = ffn_forward(p, common.rms_norm(h, p.norm2, cfg.norm_eps), cfg)
    return h + out, cache


def decode_step(params: LM, cfg: ModelConfig, caches: list[dict],
                tokens: torch.Tensor, cur_len: int):
    """One decode step.  tokens: (B, 1) (audio: (B, K, 1)); cur_len: the
    write position (the new token attends positions ≤ cur_len).  Returns
    (logits (B, 1, V[, K]), caches)."""
    h = embed_tokens(params, cfg, tokens)
    for layer, cache in zip(params.layers, caches):
        h, _ = _decode_one(layer, cache, h, cur_len, cfg)
    return _logits(params, cfg, h), caches
