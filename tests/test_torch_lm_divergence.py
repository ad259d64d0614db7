"""A deliberate divergence of the port's LM prefill from the reference,
pinned.

The reference's prefill (``repro/models/attention.py::_run_q_blocks``) cuts
the keys into ``nk = L // min(attn_block_k, L)`` blocks, so a length that
is a multiple of ``attn_block_q`` but not of ``attn_block_k`` loses its
tail of keys: at the default blocks of 512 queries and 1,024 keys and
L = 1,536 it attends keys 0-1,023 only.  The port's ``gqa_forward``
(``repro_torch/models/attention.py``) takes the same length and attends
every key, as plain causal attention does; the reference's own decode
attends the whole cache.  One dense config at narrow width, float32 on the
CPU: the port equals plain causal attention (computed here in float64) on
every row, the reference equals it on rows 0-1,023 and differs on every
row from 1,024 on.  Tolerance 1e-5: float32 sums in another order."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.configs import registry
from repro_torch.models import attention

torch.set_num_threads(1)

L, BLOCK_Q, BLOCK_K = 1536, 512, 1024
TOL = 1e-5


def _setup():
    """(reference config, port config, params as numpy, x, positions)."""
    kw = dict(num_patches=0, num_kv_heads=2, attn_block_q=BLOCK_Q,
              attn_block_k=BLOCK_K)
    jc = dataclasses.replace(jregistry.smoke("llama3.2-3b"), **kw)
    tc = dataclasses.replace(registry.smoke("llama3.2-3b"), **kw)
    d, h, kvh, hd = tc.d_model, tc.num_heads, tc.num_kv_heads, tc.head_dim
    rng = np.random.default_rng(0)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"wq": normal((d, h, hd), d ** -0.5),
         "wk": normal((d, kvh, hd), d ** -0.5),
         "wv": normal((d, kvh, hd), d ** -0.5),
         "wo": normal((h, hd, d), (h * hd) ** -0.5)}
    x = normal((1, L, d), 1.0)
    pos = np.arange(L, dtype=np.int32)[None]
    return jc, tc, p, x, pos


def _plain_causal(p, x, pos, cfg):
    """Causal softmax attention over every key, in float64 after the
    projections and the reference's RoPE."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = np.einsum("bld,dhk->blhk", x, p["wq"])
    k = np.einsum("bld,dhk->blhk", x, p["wk"])
    v = np.einsum("bld,dhk->blhk", x, p["wv"]).astype(np.float64)
    q = np.asarray(jcommon.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                      cfg.rope_theta), np.float64)
    k = np.asarray(jcommon.apply_rope(jnp.asarray(k), jnp.asarray(pos),
                                      cfg.rope_theta), np.float64)
    k = np.repeat(k, h // kvh, axis=2)
    v = np.repeat(v, h // kvh, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", w, v)
    return np.einsum("blhk,hkd->bld", out, p["wo"].astype(np.float64))


def test_port_prefill_attends_every_key_and_the_reference_drops_the_tail():
    jc, tc, p, x, pos = _setup()
    assert L % min(BLOCK_Q, L) == 0 and L % min(BLOCK_K, L) != 0
    plain = _plain_causal(p, x, pos, tc)[0]                    # (L, d)
    port, _ = attention.gqa_forward({k: torch.from_numpy(a)
                                     for k, a in p.items()},
                                    torch.from_numpy(x),
                                    torch.from_numpy(pos), tc)
    ref, _ = jattn.gqa_forward({k: jnp.asarray(a) for k, a in p.items()},
                               jnp.asarray(x), jnp.asarray(pos), jc)
    port_err = np.abs(port[0].numpy() - plain).max(-1)        # per row
    ref_err = np.abs(np.asarray(ref)[0] - plain).max(-1)
    assert port_err.max() < TOL
    assert ref_err[:BLOCK_K].max() < TOL
    # Row 1,024 misses only its own key, among 1,025: still far above TOL.
    assert ref_err[BLOCK_K:].min() > 100 * TOL
