"""Architecture registry: ``--arch <id>`` resolution for every assigned
config plus reduced smoke variants (same family, tiny dims) used by tests.

A copy of the reference's ``configs/registry.py``: the same ids, the same
full configurations and the same smoke reductions, so a test can build one
configuration in both packages.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "nemotron-4-340b", "qwen1.5-110b", "llama3.2-3b", "command-r-35b",
    "deepseek-v3-671b", "llama4-maverick-400b-a17b", "zamba2-2.7b",
    "phi-3-vision-4.2b", "mamba2-1.3b", "musicgen-medium",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get(name: str) -> ModelConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.CONFIG


def smoke(name: str) -> ModelConfig:
    """Reduced config of the same family: small layers/width/experts/vocab,
    runnable on CPU in seconds."""
    cfg = get(name)
    d = 64
    heads = 4
    kv = min(cfg.num_kv_heads, heads) if cfg.num_kv_heads else 0
    if cfg.num_heads and cfg.num_kv_heads == cfg.num_heads:
        kv = heads
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, len_pattern(cfg)),
        d_model=d,
        num_heads=heads if cfg.num_heads else 0,
        num_kv_heads=kv,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=2 if cfg.family in ("ssm", "hybrid") else 0,
        ssm_chunk=16,
        num_experts=4 if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        first_dense_layers=1 if cfg.first_dense_layers else 0,
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        rope_head_dim=8 if cfg.rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        num_patches=4 if cfg.num_patches else 0,
        attn_block_q=16, attn_block_k=16,
        dtype="float32",
    )
    if cfg.family == "moe":
        # keep the dense/moe interleave valid for a small layer count
        n = 4 if cfg.first_dense_layers or cfg.moe_every > 1 else 2
        updates["num_layers"] = n
    if cfg.family == "hybrid":
        updates["hybrid_attn_every"] = 2
        updates["num_layers"] = 4
    return dataclasses.replace(cfg, **updates)


def len_pattern(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.hybrid_attn_every
    if cfg.family == "moe" and cfg.moe_every > 1:
        return cfg.moe_every
    return 1
