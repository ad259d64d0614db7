"""Random weights in the reference's parameter-tree layout, from numpy.

`numpy_params` draws the tree that the reference's
``models/model.py::init_params`` returns — ``embedding``, ``unembed``,
``final_norm``, a VLM config's ``patch_proj``, a hybrid config's
``shared_attn`` (``norm1``, ``attn``, ``norm2``, ``mlp``, no group axis)
and one stack per `model.stacks_of` entry, holding ``block{i}`` per
pattern position, whose leaves lead with the stack's group axis (``wq (G, d, h, hd)``, ``experts_w1 (G, E, d,
fe)``, a mamba block's ``mamba.in_proj (G, d, 2·d_inner + 2S + H)``, …)
— with ``numpy.random.default_rng(seed)`` in float32 (MoE routers too, as
the reference keeps them), at the reference's scales and values
(fan-in-scaled normals, unit-normal embeddings, the conv's normals × 0.1,
unit norms, zero biases; a mixer's ``a_log`` 0, ``d_skip`` 1, ``dt_bias``
0).  `numpy_ssm_heads` redraws a tree's per-head mixer parameters, whose
init values are the same for every head.  Neither JAX nor a card
is needed, so a golden script can hand the tree to the reference and a GPU
run can load the same weights into the port
(`repro_torch.convert.lm_params_from_jax`).

`numpy_moe` draws one MoE layer with a generator of its own per expert,
so that a rank of an expert-parallel mesh draws only the experts it holds.
`numpy_patch_embeds` draws a VLM batch's patch embeddings as the
reference's data pipeline does.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import shared_d_ff
from repro_torch.models.model import MAMBA_KINDS, PATCH_EMBED_DIM, stacks_of


def _normal(rng, shape, scale):
    a = rng.standard_normal(shape, dtype=np.float32)
    a *= np.float32(scale)
    return a


def _attn(rng, cfg: ModelConfig, g: int) -> dict:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    if cfg.attention == "mla":
        rd, qr, kr = cfg.rope_head_dim, cfg.q_lora_rank, cfg.kv_lora_rank
        vd = cfg.v_head_dim or hd
        return {"w_dq": _normal(rng, (g, d, qr), d ** -0.5),
                "q_norm": np.ones((g, qr), np.float32),
                "w_uq": _normal(rng, (g, qr, h, hd + rd), qr ** -0.5),
                "w_dkv": _normal(rng, (g, d, kr + rd), d ** -0.5),
                "kv_norm": np.ones((g, kr), np.float32),
                "w_uk": _normal(rng, (g, kr, h, hd), kr ** -0.5),
                "w_uv": _normal(rng, (g, kr, h, vd), kr ** -0.5),
                "wo": _normal(rng, (g, h, vd, d), (h * vd) ** -0.5)}
    kvh = cfg.num_kv_heads
    attn = {"wq": _normal(rng, (g, d, h, hd), d ** -0.5),
            "wk": _normal(rng, (g, d, kvh, hd), d ** -0.5),
            "wv": _normal(rng, (g, d, kvh, hd), d ** -0.5),
            "wo": _normal(rng, (g, h, hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kvh), ("bv", kvh)):
            attn[name] = np.zeros((g, heads, hd), np.float32)
    return attn


def _mlp(rng, cfg: ModelConfig, lead: tuple, f: int) -> dict:
    d = cfg.d_model
    p = {"w1": _normal(rng, (*lead, d, f), d ** -0.5),
         "w2": _normal(rng, (*lead, f, d), f ** -0.5)}
    if cfg.gated_mlp:
        p["w3"] = _normal(rng, (*lead, d, f), d ** -0.5)
    return p


def _moe(rng, cfg: ModelConfig, g: int) -> dict:
    d, e = cfg.d_model, cfg.num_experts
    p = {"router": _normal(rng, (g, d, e), d ** -0.5)}
    for k, w in _mlp(rng, cfg, (g, e), cfg.moe_d_ff or cfg.d_ff).items():
        p[f"experts_{k}"] = w
    if cfg.num_shared_experts:
        p["shared"] = _mlp(rng, cfg, (g,), shared_d_ff(cfg))
    return p


def _mamba(rng, cfg: ModelConfig, g: int) -> dict:
    d, di, s, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"in_proj": _normal(rng, (g, d, 2 * di + 2 * s + h), d ** -0.5),
            "conv": _normal(rng, (g, cfg.conv_width, di + 2 * s), 0.1),
            "a_log": np.zeros((g, h), np.float32),
            "d_skip": np.ones((g, h), np.float32),
            "dt_bias": np.zeros((g, h), np.float32),
            "norm": np.ones((g, di), np.float32),
            "out_proj": _normal(rng, (g, di, d), di ** -0.5)}


def _block(rng, cfg: ModelConfig, kind: str, g: int) -> dict:
    d = cfg.d_model
    if kind in MAMBA_KINDS:
        return {"norm1": np.ones((g, d), np.float32),
                "mamba": _mamba(rng, cfg, g)}
    block = {"norm1": np.ones((g, d), np.float32),
             "attn": _attn(rng, cfg, g),
             "norm2": np.ones((g, d), np.float32)}
    if kind == "moe":
        block["moe"] = _moe(rng, cfg, g)
    else:
        block["mlp"] = _mlp(rng, cfg, (g,), cfg.d_ff)
    return block


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, v = cfg.d_model, cfg.vocab_size
    tree = {}
    if cfg.num_codebooks:
        tree["embedding"] = _normal(rng, (cfg.num_codebooks, v, d), 1.0)
        tree["unembed"] = _normal(rng, (d, cfg.num_codebooks * v),
                                  d ** -0.5)
    else:
        tree["embedding"] = _normal(rng, (v, d), 1.0)
        tree["unembed"] = _normal(rng, (d, v), d ** -0.5)
    if cfg.num_patches:
        tree["patch_proj"] = _normal(rng, (PATCH_EMBED_DIM, d),
                                     PATCH_EMBED_DIM ** -0.5)
    if cfg.family == "hybrid":        # the shared block, without a G axis
        shared = _block(rng, cfg, "dense", 1)
        tree["shared_attn"] = {k: (v[0] if isinstance(v, np.ndarray) else
                                   {n: a[0] for n, a in v.items()})
                               for k, v in shared.items()}
    tree["stacks"] = [{f"block{i}": _block(rng, cfg, kind, g)
                       for i, kind in enumerate(pattern)}
                      for pattern, g in stacks_of(cfg)]
    tree["final_norm"] = np.ones((d,), np.float32)
    return tree


def numpy_ssm_heads(tree: dict, cfg: ModelConfig, seed: int) -> dict:
    """Redraw, in place, every mamba block's per-head ``a_log`` (log A, A
    uniform in [1, 16]), ``dt_bias`` (softplus⁻¹ of dt, dt log-uniform in
    [1e-3, 1e-1]) and ``d_skip`` (uniform in [0.5, 1.5]), and its
    per-channel ``norm`` (uniform in [0.5, 1.5]), from
    ``numpy.random.default_rng((seed, 1))`` in stack, block and that
    order — Mamba2's own init ranges, where the reference's init gives
    every head the same value, so that a head-order mistake shows.
    Returns ``tree``."""
    rng = np.random.default_rng((seed, 1))
    for pattern, stack in zip((p for p, _ in stacks_of(cfg)),
                              tree["stacks"], strict=True):
        for i, kind in enumerate(pattern):
            if kind not in MAMBA_KINDS:
                continue
            m = stack[f"block{i}"]["mamba"]
            m["a_log"] = np.log(rng.uniform(1, 16, m["a_log"].shape)
                                ).astype(np.float32)
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                    m["dt_bias"].shape))
            m["dt_bias"] = np.log(np.expm1(dt)).astype(np.float32)
            m["d_skip"] = rng.uniform(0.5, 1.5, m["d_skip"].shape
                                      ).astype(np.float32)
            m["norm"] = rng.uniform(0.5, 1.5, m["norm"].shape
                                    ).astype(np.float32)
    return tree


def numpy_moe(cfg: ModelConfig, seed: int, experts=None) -> dict:
    """One MoE layer in the reference's ``init_moe`` layout, float32: the
    router and shared expert from ``default_rng((seed, 0))``, expert ``e``
    from ``default_rng((seed, 1 + e))``; ``experts`` (default all) picks
    which experts the ``experts_*`` stacks hold, in that order."""
    rng = np.random.default_rng((seed, 0))
    d = cfg.d_model
    p = {"router": _normal(rng, (d, cfg.num_experts), d ** -0.5)}
    if cfg.num_shared_experts:
        p["shared"] = _mlp(rng, cfg, (), shared_d_ff(cfg))
    ids = range(cfg.num_experts) if experts is None else experts
    mats = [_mlp(np.random.default_rng((seed, 1 + e)), cfg, (),
                 cfg.moe_d_ff or cfg.d_ff) for e in ids]
    for k in mats[0]:
        p[f"experts_{k}"] = np.stack([m[k] for m in mats])
    return p


def numpy_moe_input(cfg: ModelConfig, seed: int, batch: int,
                    seq: int) -> np.ndarray:
    """(batch, seq, d) float32 unit normals for `numpy_moe`'s layer, from
    ``default_rng((seed, 65536))``."""
    return np.random.default_rng((seed, 65536)).standard_normal(
        (batch, seq, cfg.d_model), dtype=np.float32)


def numpy_patch_embeds(cfg: ModelConfig, seed: int,
                       batch: int) -> np.ndarray:
    """(batch, num_patches, PATCH_EMBED_DIM) float32 patch embeddings,
    normal with σ 0.3 from ``default_rng(seed)``, drawn in float64 and
    cast, as the reference's ``data/pipeline.py`` draws them."""
    return np.random.default_rng(seed).normal(
        0, 0.3, (batch, cfg.num_patches, PATCH_EMBED_DIM)).astype(np.float32)
