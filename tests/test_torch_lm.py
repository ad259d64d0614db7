"""Port ≡ reference for the LM serving path of the dense-attention family.

Each module of ``repro_torch.models`` and ``repro_torch.serve.engine`` is
held against its counterpart in ``repro`` on the same inputs (numpy from a
seed) and, for whole models, the same weights: the reference's
``init_params`` tree carried across by `convert.lm_params_from_jax`.  All
in float32 on the CPU, where attention runs the flash kernel's plain
version.  Tolerances: 1e-5 per module, 1e-4 for whole-model logits and
caches (two layers of float32 matmuls summed in another order), greedy
tokens exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import decode as jdecode
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve as tserve
from repro_torch.models import attention, common, decode, init, mlp, model
from repro_torch.serve import engine

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DENSE_ARCHS = ["llama3.2-3b", "qwen1.5-110b", "command-r-35b",
               "nemotron-4-340b", "phi-3-vision-4.2b", "musicgen-medium"]
UNPORTED_ARCHS = ["deepseek-v3-671b", "llama4-maverick-400b-a17b",
                  "zamba2-2.7b", "mamba2-1.3b"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(arch):
    """(reference config, port config): the smoke config, patches off."""
    return (dataclasses.replace(jregistry.smoke(arch), num_patches=0),
            dataclasses.replace(registry.smoke(arch), num_patches=0))


def _gqa_cfgs(**kw):
    """Smoke llama with two KV heads (two query heads per group), so a
    wrong head order shows."""
    jc, tc = _cfgs("llama3.2-3b")
    kw = dict(num_kv_heads=2, **kw)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _gqa_params(cfg, rng):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _normal(rng, (d, h, hd), d ** -0.5),
         "wk": _normal(rng, (d, kvh, hd), d ** -0.5),
         "wv": _normal(rng, (d, kvh, hd), d ** -0.5),
         "wo": _normal(rng, (h, hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=_normal(rng, (h, hd)), bk=_normal(rng, (kvh, hd)),
                 bv=_normal(rng, (kvh, hd)))
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: _t(a) for k, a in p.items()})


# ------------------------------------------------------------------ config
def test_registry_and_configs_equal_the_reference():
    for arch in registry.ARCHS:
        for get in ("get", "smoke"):
            assert dataclasses.asdict(getattr(registry, get)(arch)) == \
                dataclasses.asdict(getattr(jregistry, get)(arch)), arch
        assert registry.get(arch).param_count() == \
            jregistry.get(arch).param_count()
    assert registry.get("llama3.2-3b").param_count() == 3_606_752_256


# ----------------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, scale = _normal(rng, (3, 5, 64), 3.0), _normal(rng, (64,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jcommon.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale, jd), 1e-5)
    got = common.rms_norm(_t(x).to(td), _t(scale).to(td), 1e-5)
    assert got.dtype == td
    # bfloat16: the cast before the scale multiply rounds twice, as the
    # reference does; one bf16 ulp of slack for the two libraries' rsqrt.
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("head_dim,theta", [(128, 500_000.0), (16, 10_000.0),
                                            (64, 1_000_000.0)])
def test_apply_rope_far_positions(head_dim, theta):
    """Positions up to 4,096 with θ up to 1e6: the float64-then-float32
    frequencies must match the reference's to 1e-5."""
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 64, 3, head_dim))
    pos = np.sort(rng.integers(0, 4097, (2, 64)), axis=1)
    pos[:, -1] = 4096
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(common.apply_rope(_t(x), torch.from_numpy(pos), theta), want,
           1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "nemotron-4-340b",
                                  "musicgen-medium"])
def test_mlp_forward(arch):
    """Gated silu (llama), ungated relu2 (nemotron), ungated gelu
    (musicgen)."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(2)
    d, f = tc.d_model, tc.d_ff
    p = {"w1": _normal(rng, (d, f), d ** -0.5),
         "w2": _normal(rng, (f, d), f ** -0.5)}
    if tc.gated_mlp:
        p["w3"] = _normal(rng, (d, f), d ** -0.5)
    x = _normal(rng, (2, 7, d), 2.0)
    want = jmlp.mlp_forward({k: jnp.asarray(a) for k, a in p.items()},
                            jnp.asarray(x), jc)
    got = mlp.mlp_forward({k: _t(a) for k, a in p.items()}, _t(x), tc)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("L", [16, 48])
def test_gqa_forward(bias, L):
    jc, tc = _gqa_cfgs(qkv_bias=bias)
    rng = np.random.default_rng(L)
    jp, tp = _gqa_params(tc, rng)
    x = _normal(rng, (2, L, tc.d_model))
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(L), (2, L)))
    want, (wk, wv) = jattn.gqa_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                       jc)
    got, (gk, gv) = attention.gqa_forward(tp, _t(x), torch.from_numpy(pos),
                                          tc)
    _close(got, want, 1e-5)
    _close(gk, wk, 1e-5)
    _close(gv, wv, 1e-5)


def test_gqa_forward_refuses_lengths_the_reference_cannot_take():
    _, tc = _gqa_cfgs()
    tp = _gqa_params(tc, np.random.default_rng(0))[1]
    x = torch.zeros((1, 24, tc.d_model))        # 24 % min(16, 24) != 0
    with pytest.raises(ValueError):
        attention.gqa_forward(tp, x, torch.arange(24)[None], tc)
    attention.gqa_forward(tp, x[:, :12], torch.arange(12)[None], tc)


@pytest.mark.parametrize("cur_len", [0, 9, 15])
def test_gqa_decode_on_padded_cache(cur_len):
    """One token at ``cur_len`` over a 16-slot cache whose slots after
    ``cur_len`` hold garbage: output and the written cache match."""
    jc, tc = _gqa_cfgs(qkv_bias=True)
    rng = np.random.default_rng(cur_len)
    jp, tp = _gqa_params(tc, rng)
    x = _normal(rng, (2, 1, tc.d_model))
    shape = (2, 16, tc.num_kv_heads, tc.head_dim)
    ck, cv = _normal(rng, shape), _normal(rng, shape)
    want, wc = jattn.gqa_decode(jp, jnp.asarray(x), {
        "k": jnp.asarray(ck), "v": jnp.asarray(cv)}, cur_len, jc)
    cache = {"k": _t(ck), "v": _t(cv)}
    got, gc = attention.gqa_decode(tp, _t(x), cache, cur_len, tc)
    assert gc is cache
    _close(got, want, 1e-5)
    _close(gc["k"], wc["k"], 1e-5)
    _close(gc["v"], wc["v"], 1e-5)


# ------------------------------------------------------------ whole model
def _prompt(cfg, B, L, seed):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_codebooks, L) if cfg.num_codebooks else (B, L)
    return rng.integers(0, cfg.vocab_size, shape)


_RUNS = {}


def _run(arch):
    """The reference's and the port's results for one arch, computed once:
    prefill (B 2, L 16) logits and caches, 4 teacher-forced decode steps,
    and 4 greedy tokens."""
    if arch in _RUNS:
        return _RUNS[arch]
    jc, tc = _cfgs(arch)
    jparams = jmodel.init_params(jax.random.key(7), jc)
    tparams = convert.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tc, device="cpu")
    B, L, T, max_len = 2, 16, 4, 24
    prompt = _prompt(tc, B, L, 3)
    forced = _prompt(tc, B, T, 4)

    def tok(step):
        return forced[..., step:step + 1]

    out = {}
    wl, wc, _ = jengine.prefill(jparams, jc, {"tokens": jnp.asarray(prompt)},
                                max_len)
    full, _, _ = jmodel.forward(jparams, jc, {"tokens": jnp.asarray(prompt)})
    step = jax.jit(lambda p, c, t, n: jdecode.decode_step(p, jc, c, t, n))
    wsteps = []
    for i in range(T):
        lg, wc = step(jparams, wc, jnp.asarray(tok(i)), jnp.int32(L + i))
        wsteps.append(np.asarray(lg))
    out["want"] = dict(full=np.asarray(full), last=np.asarray(wl),
                       steps=wsteps, tokens=np.asarray(jengine.generate(
                           jparams, jc, jnp.asarray(prompt), T,
                           temperature=0.0)))
    wcache = jengine.caches_from_prefill(
        jc, jmodel.forward(jparams, jc, {"tokens": jnp.asarray(prompt)},
                           collect_cache=True)[2], max_len)
    out["want"]["cache"] = wcache[0]["block0"]

    tprompt = torch.from_numpy(prompt)
    gl, gc, plen = engine.prefill(tparams, tc, {"tokens": tprompt}, max_len)
    assert plen == L
    gfull, _, _ = model.forward(tparams, tc, {"tokens": tprompt})
    gcache = [{k: c[k].clone() for k in c} for c in gc]
    gsteps = []
    for i in range(T):
        lg, gc = decode.decode_step(tparams, tc, gc, torch.from_numpy(tok(i)),
                                    L + i)
        gsteps.append(lg)
    out["got"] = dict(full=gfull, last=gl, steps=gsteps, cache=gcache,
                      tokens=engine.generate(tparams, tc, tprompt, T,
                                             temperature=0.0))
    _RUNS[arch] = out
    return out


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_and_prefill_caches(arch):
    r = _run(arch)
    tc = _cfgs(arch)[1]
    want, got = r["want"], r["got"]
    assert got["full"].shape == want["full"].shape
    _close(got["full"], want["full"], 1e-4)
    _close(got["last"], want["last"], 1e-4)
    for layer, cache in enumerate(got["cache"]):
        assert cache["k"].shape == (2, 24, tc.num_kv_heads, tc.head_dim)
        for name in ("k", "v"):
            _close(cache[name], want["cache"][name][layer], 1e-4)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_teacher_forced_decode_logits(arch):
    r = _run(arch)
    for got, want in zip(r["got"]["steps"], r["want"]["steps"]):
        assert got.shape == want.shape
        _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_greedy_generate_tokens_equal(arch):
    r = _run(arch)
    got = r["got"]["tokens"].numpy()
    assert got.shape == r["want"]["tokens"].shape
    np.testing.assert_array_equal(got, r["want"]["tokens"])


def test_teacher_forced_decode_equals_forward():
    """The port's own gold check (the reference's
    test_teacher_forced_decode_matches_forward): feeding a sequence one
    token at a time through decode_step from empty caches gives the
    full forward's logits."""
    _, tc = _gqa_cfgs()
    params = model.init_params(tc, seed=1, device="cpu")
    tokens = torch.from_numpy(_prompt(tc, 2, 16, 5))
    full, _, _ = model.forward(params, tc, {"tokens": tokens})
    caches = decode.init_caches(tc, 2, 16, "cpu")
    steps = [decode.decode_step(params, tc, caches, tokens[:, t:t + 1], t)[0]
             for t in range(16)]
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=1e-5,
                               rtol=1e-5)


def test_numpy_params_has_the_reference_tree_layout():
    """`numpy_params` gives the reference's tree, leaf for leaf in shape,
    so the golden script can hand it to the reference."""
    for arch in DENSE_ARCHS:
        jc, tc = _cfgs(arch)
        want = jax.eval_shape(lambda: jmodel.init_params(jax.random.key(0),
                                                         jc))
        got = init.numpy_params(tc, 0)
        assert jax.tree.structure(got) == jax.tree.structure(want), arch
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and g.dtype == np.float32, arch
    a, b = init.numpy_params(tc, 5), init.numpy_params(tc, 5)
    assert all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_launcher_smoke_on_cpu(arch, capsys):
    out = tserve.run(tserve.parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--new-tokens", "3"]))
    cfg = out["cfg"]
    shape = (2, cfg.num_codebooks, 3) if cfg.num_codebooks else (2, 3)
    assert out["tokens"].shape == shape and out["finite"]
    assert int(out["tokens"].min()) >= 0
    assert int(out["tokens"].max()) < cfg.vocab_size
    assert "[launch.serve]" in capsys.readouterr().out


@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_unported_arch_raises_before_allocating(arch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("allocated before refusing the arch")
    monkeypatch.setattr(model, "init_params", refuse)
    with pytest.raises(NotImplementedError, match="later slice"):
        tserve.run(tserve.parse_args(["--arch", arch, "--smoke", "--device",
                                      "cpu"]))


def test_launcher_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tserve.run(tserve.parse_args(["--arch", "llama3.2-3b", "--smoke"]))
