"""Port ≡ reference for the Mamba2 / SSD mixer (``models/ssm.py``).

The same numpy weights and inputs go through live ``repro`` and
``repro_torch`` in float32 on the CPU; every function of the module is held
to the reference within atol = rtol = 1e-4 (sums of float32 products in
another order).  The per-head parameters (``a_log``, ``dt_bias``,
``d_skip``) and the norm's channels are drawn at random rather than at
their init values, so that a head-order mistake shows; the configuration
has 4 heads of 32 channels."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.configs import registry
from repro_torch.models import ssm

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

TOL = 1e-4


def _cfgs(**kw):
    """(reference, port) smoke mamba2 configs with 4 heads, ``kw``
    replaced."""
    kw = dict(dict(ssm_heads=4), **kw)
    return (dataclasses.replace(jregistry.smoke("mamba2-1.3b"), **kw),
            dataclasses.replace(registry.smoke("mamba2-1.3b"), **kw))


def _params(cfg, seed):
    """numpy mixer weights, the per-head and per-channel ones drawn
    (``a_log`` = log A with A uniform in [1, 16]); returns (jax dict,
    torch dict)."""
    rng = np.random.default_rng(seed)
    d, di, s, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = {"in_proj": rng.standard_normal((d, 2 * di + 2 * s + h)) * d ** -0.5,
         "conv": rng.standard_normal((cfg.conv_width, di + 2 * s)) * 0.1,
         "a_log": np.log(rng.uniform(1.0, 16.0, h)),
         "d_skip": rng.uniform(0.5, 1.5, h),
         "dt_bias": rng.uniform(-3.0, 0.5, h),
         "norm": rng.uniform(0.5, 1.5, di),
         "out_proj": rng.standard_normal((di, d)) * di ** -0.5}
    p = {k: np.asarray(a, np.float32) for k, a in p.items()}
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: torch.from_numpy(a) for k, a in p.items()})


def _x(cfg, b, L, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((b, L, cfg.d_model))
            * scale).astype(np.float32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def test_split_takes_the_reference_columns():
    jc, tc = _cfgs()
    a = np.random.default_rng(0).standard_normal(
        (2, 3, 2 * tc.d_inner + 2 * tc.ssm_state + tc.ssm_heads)
    ).astype(np.float32)
    for got, want in zip(ssm._split(torch.from_numpy(a), tc),
                         jssm._split(jnp.asarray(a), jc), strict=True):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv(with_tail):
    jc, tc = _cfgs()
    rng = np.random.default_rng(1)
    c = tc.d_inner + 2 * tc.ssm_state
    xbc = rng.standard_normal((2, 9, c)).astype(np.float32)
    conv = (rng.standard_normal((tc.conv_width, c)) * 0.3).astype(np.float32)
    tail = (rng.standard_normal((2, tc.conv_width - 1, c)).astype(np.float32)
            if with_tail else None)
    want, wtail = jssm._causal_conv(
        jnp.asarray(xbc), jnp.asarray(conv), jc,
        None if tail is None else jnp.asarray(tail))
    got, gtail = ssm._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(conv), tc,
        None if tail is None else torch.from_numpy(tail))
    _close(got, want)
    _close(gtail, wtail)
    assert gtail.is_contiguous()


@pytest.mark.parametrize("L,chunk", [(32, 8), (64, 16), (48, 48)])
def test_mamba_forward(L, chunk):
    """Output, final state and conv tail at the reference's own cases
    (tests/test_models.py::test_mamba_chunked_matches_naive_recurrence)."""
    jc, tc = _cfgs(ssm_chunk=chunk)
    jp, tp = _params(tc, L)
    x = _x(tc, 2, L, L + 1)
    want, (ws, wt) = jssm.mamba_forward(jp, jnp.asarray(x), jc)
    got, (gs, gt) = ssm.mamba_forward(tp, torch.from_numpy(x), tc)
    assert got.shape == (2, L, tc.d_model)
    assert gs.dtype == torch.float32
    assert gs.shape == (2, tc.ssm_heads, tc.ssm_state,
                        tc.d_inner // tc.ssm_heads)
    _close(got, want)
    _close(gs, ws)
    _close(gt, wt)


def test_mamba_forward_where_the_masked_decay_overflows():
    """A = 16 in every head at chunk 48: the upper triangle's exponent
    cum_i - cum_j passes 88, where float32 exp gives inf (the reference
    hides it behind jnp.where).  The port's output is finite and the
    reference's."""
    jc, tc = _cfgs(ssm_chunk=48)
    jp, tp = _params(tc, 3)
    a_log = np.full(tc.ssm_heads, np.log(16.0), np.float32)
    jp["a_log"], tp["a_log"] = jnp.asarray(a_log), torch.from_numpy(a_log)
    x = _x(tc, 2, 48, 4)
    # The exponent the reference masks, from its own pre-SSD tensors.
    _, _, dt = jssm._split(jnp.asarray(x) @ jp["in_proj"], jc)
    dt = np.asarray(jax.nn.softplus(dt + jp["dt_bias"]))
    cum = np.cumsum(dt * -16.0, axis=1)                   # (B, L, H)
    expo = cum[:, :, None, :] - cum[:, None, :, :]        # cum_i - cum_j
    with np.errstate(over="ignore"):
        assert expo.max() > 88.0 and not np.isfinite(np.exp(expo)).all()
    want, (ws, _) = jssm.mamba_forward(jp, jnp.asarray(x), jc)
    got, (gs, _) = ssm.mamba_forward(tp, torch.from_numpy(x), tc)
    assert np.isfinite(np.asarray(want)).all()
    assert torch.isfinite(got).all() and torch.isfinite(gs).all()
    _close(got, want)
    _close(gs, ws)


def test_continuation_equals_one_pass():
    """A prefill of 32 then one of 16 continued from its conv tail and
    state gives the one-pass output and final state, in both packages."""
    jc, tc = _cfgs(ssm_chunk=16)
    jp, tp = _params(tc, 5)
    x = torch.from_numpy(_x(tc, 2, 48, 6))
    full, (fs, ft) = ssm.mamba_forward(tp, x, tc)
    a, (sa, ta) = ssm.mamba_forward(tp, x[:, :32], tc)
    b, (sb, tb) = ssm.mamba_forward(tp, x[:, 32:], tc, conv_tail=ta,
                                    init_state=sa)
    torch.testing.assert_close(torch.cat([a, b], 1), full, atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(sb, fs, atol=TOL, rtol=TOL)
    torch.testing.assert_close(tb, ft, atol=0, rtol=0)
    ja, (jsa, jta) = jssm.mamba_forward(jp, jnp.asarray(x[:, :32].numpy()),
                                        jc)
    jb, (jsb, _) = jssm.mamba_forward(jp, jnp.asarray(x[:, 32:].numpy()),
                                      jc, conv_tail=jta, init_state=jsa)
    _close(b, jb)
    _close(sb, jsb)


def test_mamba_decode_step_by_step_equals_the_reference():
    """16 decode steps from a cache the reference's and the port's prefill
    of 16 tokens made: each step's output and the cache, updated in
    place."""
    jc, tc = _cfgs()
    jp, tp = _params(tc, 7)
    x = _x(tc, 2, 32, 8)
    _, (ws, wt) = jssm.mamba_forward(jp, jnp.asarray(x[:, :16]), jc)
    _, (gs, gt) = ssm.mamba_forward(tp, torch.from_numpy(x[:, :16]), tc)
    wcache = {"state": ws, "conv": wt}
    cache = {"state": gs, "conv": gt}
    for t in range(16, 32):
        want, wcache = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         wcache, jc)
        got, same = ssm.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                     cache, tc)
        assert same is cache and cache["state"] is gs
        _close(got, want)
        _close(cache["state"], wcache["state"])
        _close(cache["conv"], wcache["conv"])


def test_mamba_decode_equals_the_forward():
    """The port's own version of the reference's
    test_mamba_decode_matches_forward_statefully: decoding a sequence
    token by token from a zero cache gives the chunked forward."""
    _, tc = _cfgs()
    _, tp = _params(tc, 9)
    x = torch.from_numpy(_x(tc, 2, 32, 10))
    full, (fs, ft) = ssm.mamba_forward(tp, x, tc)
    cache = ssm.init_mamba_cache(tc, 2, "cpu")
    outs = [ssm.mamba_decode(tp, x[:, t:t + 1], cache, tc)[0]
            for t in range(32)]
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=TOL, rtol=TOL)
    torch.testing.assert_close(cache["state"], fs, atol=TOL, rtol=TOL)
    torch.testing.assert_close(cache["conv"], ft, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_cache_and_params_shapes_and_dtypes(dtype):
    """The cache and the init's weights have the reference's shapes and
    dtypes: state and the per-head parameters float32 in every dtype,
    the rest in the working dtype; the init's values are the
    reference's."""
    jc, tc = _cfgs(dtype=dtype)
    want = jssm.init_mamba_cache(jc, 3)
    got = ssm.init_mamba_cache(tc, 3, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()
    wp = jax.eval_shape(lambda: jssm.init_mamba(jax.random.key(0), jc))
    gp = ssm.init_mamba(torch.Generator().manual_seed(0), tc)
    assert set(gp) == set(wp)
    for k in wp:
        assert tuple(gp[k].shape) == wp[k].shape, k
        assert str(gp[k].dtype).split(".")[-1] == str(wp[k].dtype), k
    assert not gp["a_log"].any() and not gp["dt_bias"].any()
    assert (gp["d_skip"] == 1).all() and (gp["norm"] == 1).all()


def test_refused_length():
    """L = 20 at chunk 8: the reference asserts, the port raises
    ValueError; neither pads."""
    jc, tc = _cfgs(ssm_chunk=8)
    jp, tp = _params(tc, 11)
    x = _x(tc, 1, 20, 12)
    with pytest.raises(AssertionError):
        jssm.mamba_forward(jp, jnp.asarray(x), jc)
    with pytest.raises(ValueError, match="multiple"):
        ssm.mamba_forward(tp, torch.from_numpy(x), tc)
    ssm.mamba_forward(tp, torch.from_numpy(x[:, :16]), tc)
