"""Single-token decode with static-shape caches (the reference's
``models/decode.py``, dense blocks).

Caches are one ``{"k", "v"}`` dict per layer, each (B, Lmax, KVH, hd) in
the working dtype (the reference stacks them over its scanned layers).
`decode_step` writes each layer's new key and value into its cache in
place and returns the same list.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, common, mlp
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, Block, _logits, check_supported,
                                      embed_tokens)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device) -> list[dict]:
    check_supported(cfg)
    dt = common.dtype_of(cfg.dtype)
    return [attention.init_gqa_cache(cfg, batch, max_len, dt, device)
            for _ in range(cfg.num_layers)]


def _decode_one(p: Block, cache: dict, h, cur_len: int, cfg: ModelConfig):
    a_out, cache = attention.gqa_decode(
        p.attn, common.rms_norm(h, p.norm1, cfg.norm_eps), cache, cur_len,
        cfg)
    h = h + a_out
    x2 = common.rms_norm(h, p.norm2, cfg.norm_eps)
    return h + mlp.mlp_forward(p.mlp, x2, cfg), cache


def decode_step(params: LM, cfg: ModelConfig, caches: list[dict],
                tokens: torch.Tensor, cur_len: int):
    """One decode step.  tokens: (B, 1) (audio: (B, K, 1)); cur_len: the
    write position (the new token attends positions ≤ cur_len).  Returns
    (logits (B, 1, V[, K]), caches)."""
    h = embed_tokens(params, cfg, tokens)
    for layer, cache in zip(params.layers, caches):
        h, _ = _decode_one(layer, cache, h, cur_len, cfg)
    return _logits(params, cfg, h), caches
