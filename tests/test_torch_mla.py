"""Port ≡ reference for Multi-head Latent Attention (deepseek-v3's MLA in
``models/attention.py``): `_mla_qkv`, the blocked `mla_forward` (at
several lengths, one of them where ``attn_block_k`` does not divide L and
the reference cuts the keys from ``(L // bk) · bk`` on), the absorbed
`mla_decode` on a padded cache, and the latent cache's shapes.  Float32
on the CPU, 1e-5, on the same numpy weights (``models/init.py``'s MLA
draw) and inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import decode as jdecode
from repro_torch.configs import registry
from repro_torch.models import attention, decode, init

torch.set_num_threads(1)


def _cfgs(**kw):
    kw = dict(kw, dtype="float32")
    return (dataclasses.replace(jregistry.smoke("deepseek-v3-671b"), **kw),
            dataclasses.replace(registry.smoke("deepseek-v3-671b"), **kw))


def _params(cfg, seed):
    """One layer's MLA weights, numpy, with non-unit norms."""
    rng = np.random.default_rng(seed)
    p = {k: v[0] for k, v in init._attn(rng, cfg, 1).items()}
    p["q_norm"] = 1 + 0.1 * rng.standard_normal(p["q_norm"].shape,
                                                dtype=np.float32)
    p["kv_norm"] = 1 + 0.1 * rng.standard_normal(p["kv_norm"].shape,
                                                 dtype=np.float32)
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: torch.from_numpy(a) for k, a in p.items()})


def _x(cfg, b, L, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, L, cfg.d_model), dtype=np.float32)


def _pos(b, L, start=0):
    return np.array(np.broadcast_to(np.arange(start, start + L), (b, L)))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_mla_qkv():
    jc, tc = _cfgs()
    jp, tp = _params(tc, 0)
    x, pos = _x(tc, 2, 12, 1), _pos(2, 12, 100)
    want = jattn._mla_qkv(jp, jnp.asarray(x), jnp.asarray(pos), jc)
    got = attention._mla_qkv(tp, torch.from_numpy(x), torch.from_numpy(pos),
                             tc)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("L,bq,bk", [(16, 16, 16), (48, 16, 16),
                                     (8, 16, 16), (64, 16, 32),
                                     (24, 8, 16), (40, 8, 16)])
def test_mla_forward(L, bq, bk):
    """Lengths of one and several blocks; at (24, bq 8, bk 16) and (40, 8,
    16) bk does not divide L, and both packages attend only keys below
    16 and 32."""
    jc, tc = _cfgs(attn_block_q=bq, attn_block_k=bk)
    jp, tp = _params(tc, L)
    x, pos = _x(tc, 2, L, L + 1), _pos(2, L)
    want, (wc, wkr) = jattn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                        jc)
    got, (gc, gkr) = attention.mla_forward(tp, torch.from_numpy(x),
                                           torch.from_numpy(pos), tc)
    _close(got, want)
    _close(gc, wc)
    _close(gkr, wkr)


def test_mla_forward_cuts_the_keys_past_the_last_whole_block():
    """At L 24 with bk 16, the last 8 positions do not see their own keys
    (the reference's cut), so the output differs from L 24 with bk 24."""
    _, cut = _cfgs(attn_block_q=8, attn_block_k=16)
    full = dataclasses.replace(cut, attn_block_k=24)
    _, tp = _params(cut, 3)
    x, pos = torch.from_numpy(_x(cut, 1, 24, 4)), torch.from_numpy(_pos(1, 24))
    a = attention.mla_forward(tp, x, pos, cut)[0]
    b = attention.mla_forward(tp, x, pos, full)[0]
    torch.testing.assert_close(a[:, :16], b[:, :16], atol=1e-6, rtol=1e-6)
    assert (a[:, 16:] - b[:, 16:]).abs().max() > 1e-3


def test_mla_forward_refuses_lengths_the_reference_cannot_take():
    _, tc = _cfgs()
    _, tp = _params(tc, 0)
    x = torch.zeros((1, 24, tc.d_model))        # 24 % min(16, 24) != 0
    with pytest.raises(ValueError):
        attention.mla_forward(tp, x, torch.arange(24)[None], tc)
    attention.mla_forward(tp, x[:, :12], torch.arange(12)[None], tc)


@pytest.mark.parametrize("cur_len", [0, 5, 9, 15])
def test_mla_decode_on_padded_cache(cur_len):
    """One token at ``cur_len`` over a 16-slot latent cache whose slots
    after ``cur_len`` hold garbage: output and the written cache match."""
    jc, tc = _cfgs()
    jp, tp = _params(tc, cur_len + 10)
    rng = np.random.default_rng(cur_len)
    x = _x(tc, 2, 1, cur_len + 20)
    cc = rng.standard_normal((2, 16, tc.kv_lora_rank), dtype=np.float32)
    ckr = rng.standard_normal((2, 16, tc.rope_head_dim), dtype=np.float32)
    want, wc = jattn.mla_decode(jp, jnp.asarray(x), {
        "c": jnp.asarray(cc), "k_rope": jnp.asarray(ckr)}, cur_len, jc)
    cache = {"c": torch.from_numpy(cc.copy()),
             "k_rope": torch.from_numpy(ckr.copy())}
    got, gc = attention.mla_decode(tp, torch.from_numpy(x), cache, cur_len,
                                   tc)
    assert gc is cache
    _close(got, want)
    _close(gc["c"], wc["c"])
    _close(gc["k_rope"], wc["k_rope"])


def test_latent_cache_shapes():
    jc, tc = _cfgs()
    want = jdecode.init_caches(jc, 3, 20)
    got = decode.init_caches(tc, 3, 20, "cpu")
    assert len(got) == tc.num_layers
    for c in got:
        assert set(c) == {"c", "k_rope"}
        assert c["c"].shape == (3, 20, tc.kv_lora_rank)
        assert c["k_rope"].shape == (3, 20, tc.rope_head_dim)
    # the reference stacks each stack's caches over its groups
    for stack in want:
        for blk in stack.values():
            assert blk["c"].shape[1:] == (3, 20, tc.kv_lora_rank)
            assert blk["k_rope"].shape[1:] == (3, 20, tc.rope_head_dim)
