"""Dense MLP of the LM substrate (the dense part of the reference's
``models/mlp.py``): gated (SwiGLU-style) or plain, weights ``w1 (d, f)``,
``w2 (f, d)`` and, gated, ``w3 (d, f)``.  Mixture-of-Experts is not ported
yet."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

MOE_UNPORTED = ("Mixture-of-Experts (models/mlp.py moe_forward: deepseek-v3, "
                "llama4-maverick) is not ported yet: it comes with a later "
                "slice of the LM substrate (ROADMAP queue 1, item 15)")


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None):
    """One layer's MLP weights on ``gen``'s device, drawn in the
    reference's order (w1, w2, then w3 when gated)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = common.dtype_of(cfg.dtype)
    p = {"w1": common.dense_init(gen, d, (f,), dt),
         "w2": common.dense_init(gen, f, (d,), dt)}
    if cfg.gated_mlp:
        p["w3"] = common.dense_init(gen, d, (f,), dt)
    return common.param_dict(p)


def mlp_forward(p, x, cfg: ModelConfig):
    act = common.activation_fn(cfg.activation)
    h = act(x @ p["w1"])
    if cfg.gated_mlp:
        h = h * (x @ p["w3"])
    return h @ p["w2"]


def moe_forward(p, x, cfg: ModelConfig):
    raise NotImplementedError(MOE_UNPORTED)
