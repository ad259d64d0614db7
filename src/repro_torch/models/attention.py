"""Attention of the LM substrate (the reference's ``models/attention.py``):
grouped-query attention (llama / qwen / nemotron / command-r / musicgen /
phi3 / llama4) and Multi-head Latent Attention (deepseek-v3).

Prefill and decode both run the hand-written flash-attention kernel
(`kernels.ops.flash_attention`) where the reference runs its pure-XLA
blocked scan (``_run_q_blocks``, the twin of its Pallas kernel): prefill
causally with ``kv_offset=0``, decode with one query at
``kv_offset=cur_len`` over the padded cache, which masks the keys after
``cur_len`` as the reference's ``valid`` mask does.  Projections stay
``torch.matmul``, as the reference leaves them to XLA.

Parameters are the reference's layout — ``wq (d, h, hd)``,
``wk``/``wv (d, kvh, hd)``, ``wo (h, hd, d)``, biases ``(heads, hd)`` — in
an ``nn.ParameterDict`` per layer.

MLA runs in plain PyTorch, as the reference runs it in ``jnp`` and never
sends it to its Pallas kernel (Q·K has head dim ``head_dim +
rope_head_dim``, V ``v_head_dim``; the flash kernels take one head dim).
Prefill is the reference's blocked online softmax (``_run_q_blocks``):
K and V are projected from the latent ``c`` one key block at a time, the
scores of one (query block, key block) pair at a time, and keys from
``(L // bk) · bk`` on are cut as the reference cuts them.  Decode is the
absorbed form over the latent cache ``{c (B, Lmax, kv_lora_rank), k_rope
(B, Lmax, rope_head_dim)}``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

_NEG = -1e30


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


# ----------------------------------------------------------------- MLA
def init_mla(gen: torch.Generator, cfg: ModelConfig):
    """One layer's MLA weights on ``gen``'s device, drawn in the
    reference's order (w_dq, w_uq, w_dkv, w_uk, w_uv, wo; unit norms)."""
    d, h = cfg.d_model, cfg.num_heads
    hd, rd = cfg.head_dim, cfg.rope_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    vd = cfg.v_head_dim or hd
    dt = common.dtype_of(cfg.dtype)
    p = {"w_dq": common.dense_init(gen, d, (qr,), dt),
         "q_norm": torch.ones(qr, dtype=dt, device=gen.device),
         "w_uq": common.dense_init(gen, qr, (h, hd + rd), dt),
         "w_dkv": common.dense_init(gen, d, (kr + rd,), dt),
         "kv_norm": torch.ones(kr, dtype=dt, device=gen.device),
         "w_uk": common.dense_init(gen, kr, (h, hd), dt),
         "w_uv": common.dense_init(gen, kr, (h, vd), dt),
         "wo": common.dense_init(gen, h * vd, (d,), dt).reshape(h, vd, d)}
    return common.param_dict(p)


def _mla_qkv(p, x, positions, cfg: ModelConfig):
    """(q_nope (B, L, H, hd), q_rope (B, L, H, rd) rotated, c (B, L, kr)
    normed, k_rope (B, L, rd) rotated, one head shared by all)."""
    b, L, d = x.shape
    h, hd, rd = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    x2 = x.reshape(b * L, d)
    q_lat = common.rms_norm(x2 @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (q_lat @ p["w_uq"].reshape(qr, h * (hd + rd))).view(b, L, h,
                                                             hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = (x2 @ p["w_dkv"]).view(b, L, kr + rd)
    c = common.rms_norm(ckv[..., :kr], p["kv_norm"], cfg.norm_eps)
    k_rope = common.apply_rope(ckv[..., None, kr:], positions,
                               cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, c, k_rope


def _mla_kv_block(p, c_blk, kr_blk, cfg: ModelConfig):
    """One key block's K (B, bk, H, hd + rd) and V (B, bk, H, vd),
    projected from the latent in the working dtype."""
    b, bk, kr = c_blk.shape
    h, hd, rd = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    c2 = c_blk.reshape(b * bk, kr)
    k = (c2 @ p["w_uk"].reshape(kr, h * hd)).view(b, bk, h, hd)
    k = torch.cat([k, kr_blk[:, :, None, :].expand(b, bk, h, rd)], -1)
    v = (c2 @ p["w_uv"].reshape(kr, -1)).view(b, bk, h, -1)
    return k, v


def _blocked_mla(p, q, c, k_rope, cfg: ModelConfig, bq: int, bk: int):
    """The reference's ``_run_q_blocks`` / ``_blocked_attn`` for MLA
    (KVH = H, G = 1, kv_offset 0), in float32: q (B, L, H, hd + rd) →
    (B, L, H, vd).

    Each query block runs the online softmax over key blocks 0..nk-1 in
    order, nk = L // bk.  The key blocks are the outer loop, so each is
    projected once; a (query block, key block) pair whose keys all lie
    after its queries is skipped, which is exact: the reference's update
    for it has p = 0 and alpha = 1."""
    b, L, h, _ = q.shape
    nq, nk = L // bq, L // bk
    scale = (cfg.head_dim + cfg.rope_head_dim) ** -0.5
    qf = (q.float() * scale).transpose(1, 2)              # (B, H, L, hd+rd)
    q_pos = torch.arange(L, device=q.device)
    m = torch.full((b, h, L), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, L), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, L, cfg.v_head_dim or cfg.head_dim),
                      dtype=torch.float32, device=q.device)
    for j in range(nk):
        keys = slice(j * bk, (j + 1) * bk)
        k_blk, v_blk = _mla_kv_block(p, c[:, keys], k_rope[:, keys], cfg)
        kf = k_blk.float().permute(0, 2, 3, 1)            # (B, H, hd+rd, bk)
        vf = v_blk.float().transpose(1, 2)                # (B, H, bk, vd)
        del k_blk, v_blk
        k_pos = torch.arange(j * bk, (j + 1) * bk, device=q.device)
        for i in range(nq):
            if j * bk > (i + 1) * bq - 1:
                continue
            rows = slice(i * bq, (i + 1) * bq)
            s = torch.matmul(qf[:, :, rows], kf)          # (B, H, bq, bk)
            s.masked_fill_(k_pos[None, :] > q_pos[rows, None], _NEG)
            m_i = m[:, :, rows]
            m_new = torch.maximum(m_i, s.amax(-1))
            s.sub_(m_new[..., None]).exp_()                # p, in place
            alpha = torch.exp(m_i - m_new)
            l[:, :, rows] = l[:, :, rows] * alpha + s.sum(-1)
            acc[:, :, rows] = (acc[:, :, rows] * alpha[..., None]
                               + torch.matmul(s, vf))
            m[:, :, rows] = m_new
            del s
    out = acc / l.clamp_min(1e-30)[..., None]             # (B, H, L, vd)
    return out.transpose(1, 2)


def mla_forward(p, x, positions, cfg: ModelConfig):
    """MLA prefill (module docstring).  x: (B, L, D) → (B, L, D), and the
    latent cache pair (c (B, L, kr), k_rope (B, L, rd)).  Raises for a
    length the reference's blocked scan cannot reshape (L a multiple of
    ``min(attn_block_q, L)``)."""
    b, L, d = x.shape
    bq, bk = min(cfg.attn_block_q, L), min(cfg.attn_block_k, L)
    if L < 1 or L % bq:
        raise ValueError(f"prompt length {L} is not a multiple of "
                         f"min(attn_block_q={cfg.attn_block_q}, L), which "
                         "the reference's prefill requires")
    q_nope, q_rope, c, k_rope = _mla_qkv(p, x, positions, cfg)
    q = torch.cat([q_nope, q_rope], -1)                   # (B, L, H, hd+rd)
    del q_nope, q_rope
    out = _blocked_mla(p, q, c, k_rope, cfg, bq, bk).to(x.dtype)
    return _out_proj(p, out, cfg), (c, k_rope)


def mla_decode(p, x, cache, cur_len: int, cfg: ModelConfig):
    """Absorbed-MLA decode: x (B, 1, D); cache = {c (B, Lc, kr), k_rope
    (B, Lc, rd)}, written in place at ``cur_len`` and returned.  W_uk is
    absorbed into the query (scores against the latent itself) and W_uv
    applied after the weighted sum, in float32 as the reference."""
    b = x.shape[0]
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(p, x, pos, cfg)
    cache["c"][:, cur_len:cur_len + 1].copy_(c_new)
    cache["k_rope"][:, cur_len:cur_len + 1].copy_(kr_new)
    cc = cache["c"].float()                               # (B, Lc, kr)
    ckr = cache["k_rope"].float()
    # q_lat[b, h, r] = Σ_k q_nope[b, h, k] · w_uk[r, h, k]
    q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1),
                         p["w_uk"].permute(1, 2, 0)).transpose(0, 1)
    scale = (cfg.head_dim + cfg.rope_head_dim) ** -0.5
    s = (torch.matmul(q_lat.float(), cc.transpose(1, 2))
         + torch.matmul(q_rope[:, 0].float(), ckr.transpose(1, 2))) * scale
    valid = torch.arange(cc.shape[1], device=x.device) <= cur_len
    att = torch.softmax(s.masked_fill(~valid, _NEG), -1)  # (B, H, Lc)
    o_lat = torch.matmul(att, cc)                         # (B, H, kr)
    out = torch.matmul(o_lat.transpose(0, 1),
                       p["w_uv"].float().transpose(0, 1)).transpose(0, 1)
    return _out_proj(p, out[:, None].to(x.dtype), cfg), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    return {"c": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}
