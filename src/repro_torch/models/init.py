"""Random weights in the reference's parameter-tree layout, from numpy.

`numpy_params` draws the tree that the reference's
``models/model.py::init_params`` returns for a dense configuration —
``embedding``, ``unembed``, ``final_norm`` and one stack whose leaves lead
with the layer axis (``wq (G, d, h, hd)``, ``wo (G, h, hd, d)``, …) — with
``numpy.random.default_rng(seed)`` in float32, at the reference's scales
(fan-in-scaled normals, unit-normal embeddings, unit norms, zero biases).
Neither JAX nor a card is needed, so a golden script can hand the tree to
the reference and a GPU run can load the same weights into the port
(`repro_torch.convert.lm_params_from_jax`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import check_supported


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    check_supported(cfg)
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return a

    d, v, g = cfg.d_model, cfg.vocab_size, cfg.num_layers
    h, kvh, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    tree = {}
    if cfg.num_codebooks:
        tree["embedding"] = normal((cfg.num_codebooks, v, d), 1.0)
        tree["unembed"] = normal((d, cfg.num_codebooks * v), d ** -0.5)
    else:
        tree["embedding"] = normal((v, d), 1.0)
        tree["unembed"] = normal((d, v), d ** -0.5)
    attn = {"wq": normal((g, d, h, hd), d ** -0.5),
            "wk": normal((g, d, kvh, hd), d ** -0.5),
            "wv": normal((g, d, kvh, hd), d ** -0.5),
            "wo": normal((g, h, hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kvh), ("bv", kvh)):
            attn[name] = np.zeros((g, heads, hd), np.float32)
    mlp = {"w1": normal((g, d, f), d ** -0.5),
           "w2": normal((g, f, d), f ** -0.5)}
    if cfg.gated_mlp:
        mlp["w3"] = normal((g, d, f), d ** -0.5)
    ones = np.ones((g, d), np.float32)
    tree["stacks"] = [{"block0": {"norm1": ones, "attn": attn,
                                  "norm2": ones.copy(), "mlp": mlp}}]
    tree["final_norm"] = np.ones((d,), np.float32)
    return tree
