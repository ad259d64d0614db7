"""Training of every family against the reference, on the CPU: the
forward and gradient of each arch's smoke config, the gradient leaves of
the MoE, MLA, SSD and hybrid families against ``jax.value_and_grad`` with
remat on and off, two train steps of each of those families against the
reference's jitted step at 1 and 2 microbatches (and those of a
head-dim-192 cut, float32), the launcher on each, training checkpoints
that each package restores from the other's, the head-dim-192
backward's plain version in both routes' forms against ``jax.grad`` of
the reference's blocked attention, which head dims the card refuses,
and that the golden script's new cuts are the chip smoke's.

Gradient leaves are held at the tolerances of ``tests/
test_torch_train.py``'s leaf test (atol 1e-6 + rtol 1e-5) on the same
weights (`convert.lm_params_from_jax`) and batches; train steps at that
file's step test's (loss and grad norm rel 1e-5, parameters atol 2e-5,
moments atol 1e-6); the D 192 gradient at the log-sum-exp form's atol
2e-5 (``tests/test_torch_flash_bwd.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as jpipeline
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import train as tlaunch
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.step import check_trainable, make_train_step

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

FAMILY_ARCHS = ["mamba2-1.3b", "zamba2-2.7b", "deepseek-v3-671b",
                "llama4-maverick-400b-a17b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch_for(cfg, B, L, seed=0):
    """The reference's ``tests/test_models.py::_batch_for``, as tensors."""
    rng = np.random.default_rng(seed)
    if cfg.num_codebooks:
        tokens = rng.integers(0, cfg.vocab_size, (B, cfg.num_codebooks, L))
    else:
        tokens = rng.integers(0, cfg.vocab_size, (B, L - cfg.num_patches))
    tokens = torch.from_numpy(tokens)
    batch = dict(tokens=tokens, labels=tokens)
    if cfg.num_patches:
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_patches, model.PATCH_EMBED_DIM)).astype(
            np.float32)) * 0.1
    return batch


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_arch_smoke_forward_and_train_shapes(arch):
    """The reference's test of the same name on the port: forward shapes,
    finite logits and loss, and a finite nonzero gradient norm by
    autograd through `model.loss_fn` (remat as the smoke config has it)."""
    cfg = registry.smoke(arch)
    params = model.trainable(model.init_params(cfg, 0, "cpu"))
    B, L = 2, 32
    batch = _batch_for(cfg, B, L)
    logits, _, _ = model.forward(params, cfg, batch)
    if cfg.num_codebooks:
        assert logits.shape == (B, L, cfg.num_codebooks, cfg.vocab_size)
    else:
        assert logits.shape == (B, L, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any()), "NaN logits"
    loss, _ = model.loss_fn(params, cfg, batch)
    assert np.isfinite(float(loss.detach()))
    grads = torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True)
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads
                           if g is not None))
    assert np.isfinite(float(gnorm)) and float(gnorm) > 0


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_gradient_leaves_match_the_reference(arch, remat):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` against
    autograd of the port's on the same weights and batch, every leaf.
    Remat on recomputes each layer in the backward (the SSD mixer's decay
    must not be overwritten after exp saved it); remat off differentiates
    MLA's blocked prefill directly (its scores must not be updated in
    place)."""
    jc = dataclasses.replace(jregistry.smoke(arch), remat=remat)
    tc = dataclasses.replace(registry.smoke(arch), remat=remat)
    jp = jmodel.init_params(jax.random.key(0), jc)
    tp = model.trainable(convert.lm_params_from_jax(_np(jp), tc,
                                                    device="cpu"))
    b = jpipeline.SyntheticLM(jc, 4, 32, seed=1).batch_at(0)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jc, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    got, _ = model.loss_fn(tp, tc, {k: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in b.items()})
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(got, list(named.values()))
    ref = convert.lm_named_leaves(_np(want_g), tc)
    assert set(named) == set(ref)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name],
                                                         np.float32),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


@dataclasses.dataclass
class _Spec:
    """A leaf's shape; indexing drops the group axis."""
    shape: tuple

    def __getitem__(self, g):
        return _Spec(self.shape[1:])


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_stacked_tree_is_the_reference_layout(arch):
    """`convert.lm_stacked_tree` of the port's parameter names is the
    reference's parameter tree: the same paths and shapes (group axis
    leading), and `lm_named_leaves` undoes it."""
    cfg = registry.get(arch)
    named = dict(model.param_shapes(cfg).named_parameters())
    got = convert.lm_stacked_tree(
        named, cfg, lambda ts: _Spec((len(ts), *ts[0].shape)))
    want = jmodel.param_shapes(jregistry.get(arch))

    def paths(tree, is_leaf=None):
        flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf)[0]
        return {jax.tree_util.keystr(p): tuple(x.shape) for p, x in flat}

    assert paths(got, lambda x: isinstance(x, _Spec)) == paths(want)
    back = convert.lm_named_leaves(convert.lm_stacked_tree(named, cfg), cfg)
    assert set(back) == set(named)
    for name, t in back.items():
        assert tuple(t.shape) == tuple(named[name].shape), name


_LOOP_KW = dict(batch=2, seq_len=16, steps=2, ckpt_every=2, lr=1e-3,
                log_every=100, print_fn=lambda *a: None, async_ckpt=False)


def _leaves_equal(named: dict, tree, cfg):
    want = convert.lm_named_leaves(_np(tree), cfg)
    assert set(named) == set(want)
    for name, t in named.items():
        np.testing.assert_array_equal(t.detach().numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_reference_resumes_from_the_ports_training_checkpoint(tmp_path):
    """Two port steps write a checkpoint at step 2; the reference's loop
    asked for 2 steps resumes from it (``repro.checkpoint.manager.
    restore`` into its own tree) and ends with its parameters and
    moments."""
    arch = "llama3.2-3b"
    jc, tc = jregistry.smoke(arch), registry.smoke(arch)
    d = str(tmp_path / "ckpt")
    port = loop.train(tc, checkpoint_dir=d, device="cpu", **_LOOP_KW)
    ref = jloop.train(jc, checkpoint_dir=d, **_LOOP_KW)
    assert ref.resumed_from == 2 and ref.steps_run == 0
    _leaves_equal(dict(port.params.named_parameters()), ref.params, tc)
    _leaves_equal(port.opt_state.m, ref.opt_state.m, tc)
    _leaves_equal(port.opt_state.v, ref.opt_state.v, tc)
    assert int(port.opt_state.step) == int(ref.opt_state.step) == 2


def test_port_resumes_from_the_references_training_checkpoint(tmp_path):
    """The reference's loop writes a checkpoint at step 2; the port's loop
    asked for 2 steps resumes from it and ends with its parameters and
    moments."""
    arch = "llama3.2-3b"
    jc, tc = jregistry.smoke(arch), registry.smoke(arch)
    d = str(tmp_path / "ckpt")
    ref = jloop.train(jc, checkpoint_dir=d, **_LOOP_KW)
    port = loop.train(tc, checkpoint_dir=d, device="cpu", **_LOOP_KW)
    assert port.resumed_from == 2 and port.steps_run == 0
    _leaves_equal(dict(port.params.named_parameters()), ref.params, tc)
    _leaves_equal(port.opt_state.m, ref.opt_state.m, tc)
    _leaves_equal(port.opt_state.v, ref.opt_state.v, tc)
    assert int(port.opt_state.step) == 2


def test_training_refuses_a_head_dim_without_a_backward_kernel():
    """On a CUDA device every arch of the registry is admitted in float32
    and in bf16 — float32 at nemotron-4-340b's head dim 192 too, which the
    tf32x3 backward takes in three launches — while a head dim that no
    backward route takes (48: neither the simt list nor the wgmma and
    tf32x3 one; in bf16 and in float32) is refused up front, not at the
    first backward;
    the CPU (the plain version) admits every config in either dtype."""
    nemotron = registry.get("nemotron-4-340b")
    f32 = dataclasses.replace(nemotron, dtype="float32")
    check_trainable(f32, torch.device("cuda"))
    check_trainable(f32, "cuda:0")
    odd = dataclasses.replace(nemotron, head_dim=48)
    for c in (odd, dataclasses.replace(odd, dtype="float32")):
        with pytest.raises(NotImplementedError, match="head dim 48"):
            check_trainable(c, torch.device("cuda"))
        with pytest.raises(NotImplementedError, match="head dim 48"):
            check_trainable(c, "cuda:0")
        check_trainable(c, "cpu")
        check_trainable(c)
    for arch in registry.ARCHS:
        cfg = registry.get(arch)
        assert cfg.dtype == "bfloat16", arch
        for c in (cfg, dataclasses.replace(cfg, dtype="float32")):
            check_trainable(c, "cuda")
            check_trainable(c, "cpu")
            check_trainable(c)


# Train-step cases beyond FAMILY_ARCHS: a smoke cut at nemotron's head dim
# 192 (12 query heads on one KV head, 1 layer), whose backward on the card
# is the tf32x3 route's three launches; on the CPU its plain version.
STEP_CUTS = {"nemotron-4-340b-d192": ("nemotron-4-340b", dict(
    num_heads=12, num_kv_heads=1, head_dim=192, num_layers=1))}


def _smoke_pair(case):
    """The reference's and the port's smoke config of a step case: an arch
    of FAMILY_ARCHS, or a name of STEP_CUTS (its arch, cut)."""
    arch, cuts = STEP_CUTS.get(case, (case, {}))
    return (dataclasses.replace(jregistry.smoke(arch), **cuts),
            dataclasses.replace(registry.smoke(arch), **cuts))


def _steps(jc, tc, microbatches):
    """Two steps of the reference's jitted ``make_train_step`` and the
    port's (cosine lr, no warmup) from the same weights on the same
    ``SyntheticLM`` batches; returns both final states, the metrics and
    the reference's first moments after step 0 (0.1 times its first
    gradient, clipped)."""
    jp = jmodel.init_params(jax.random.key(0), jc)
    tp = model.trainable(convert.lm_params_from_jax(_np(jp), tc,
                                                    device="cpu"))
    lr = (jadamw.cosine_schedule(1e-3, 0, 10),
          adamw.cosine_schedule(1e-3, 0, 10))
    jfn = jax.jit(jstep.make_train_step(jc, lr[0], microbatches))
    tfn = make_train_step(tc, lr[1], microbatches)
    jo, to = jadamw.init(jp), adamw.init(tp)
    data = jpipeline.SyntheticLM(jc, 4, 32, seed=2)
    metrics = []
    for step in range(2):
        b = data.batch_at(step)
        jp, jo, jm = jfn(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tfn(tp, to, {k: torch.from_numpy(np.ascontiguousarray(
            v)) for k, v in b.items()})
        metrics.append((jm, tm))
        if step == 0:
            m0 = jo.m
    return jp, jo, tp, to, metrics, m0


def _close(got: dict, want_tree, cfg, atol):
    want = convert.lm_named_leaves(_np(want_tree), cfg)
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   atol=atol, rtol=0, err_msg=name)


# AdamW's first update of an element is lr · g / (|g| + eps) with eps 1e-8:
# where the first gradient |g| is below G_WELL_POSED its float32 rounding
# (sums of terms ~1e-4 that cancel, in another order on each side) moves
# the update by up to ~0.2 lr (a port/reference difference of 2e-9 at
# |g| ~ 1e-9 moves it 1.4e-4).  Such elements are held to the two steps'
# largest move, 2 lr; every other element to atol 2e-5.
G_WELL_POSED = 1e-7


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS + list(STEP_CUTS))
def test_family_train_steps_match_the_reference(arch, microbatches):
    """Two steps of ``make_train_step`` on the MoE (with MLA), SSD and
    hybrid smoke configs, and on the head-dim-192 cut of STEP_CUTS
    (float32: the tf32x3 backward's plain version at D 192), against the
    reference's: loss (the MoE aux loss in it), grad norm and lr each
    step, then every first moment (atol 1e-6) and every parameter (atol
    2e-5 where the first gradient is above G_WELL_POSED, within 2 lr
    elsewhere)."""
    jc, tc = _smoke_pair(arch)
    jp, jo, tp, to, metrics, m0 = _steps(jc, tc, microbatches)
    for jm, tm in metrics:
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _close(to.m, jo.m, tc, atol=1e-6)
    want = convert.lm_named_leaves(_np(jp), tc)
    g0 = convert.lm_named_leaves(_np(m0), tc)
    named = dict(tp.named_parameters())
    assert set(named) == set(want)
    for name, t in named.items():
        diff = np.abs(t.detach().numpy() - np.asarray(want[name]))
        well = np.abs(np.asarray(g0[name])) / 0.1 >= G_WELL_POSED
        assert diff[well].max(initial=0) <= 2e-5, (name, diff[well].max())
        assert diff.max(initial=0) <= 2e-3, (name, diff.max())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launcher_trains_every_family_on_cpu(arch, capsys):
    """``launch.train.main`` on each family's smoke config on the CPU, two
    microbatches: finite losses and grad norms, every step timed."""
    out = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--microbatches", "2", "--batch",
                        "4", "--seq-len", "32"])
    assert out["steps_run"] == 2 and len(out["step_seconds"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all()
    assert f"[launch.train] {arch}-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("causal,form", [
    pytest.param(True, "lse", id="causal"),
    pytest.param(False, "lse", id="full"),
    pytest.param(True, "simt", id="causal-simt"),
    pytest.param(False, "simt", id="full-simt")])
def test_head_dim_192_backward_matches_the_references_attention(causal, form):
    """The plain version of the D 192 backward in both its forms — the
    wgmma and tf32x3 routes', reading the forward's log-sum-exp (bf16 and
    float32 on the card), and the simt route's, recomputing it — against
    ``jax.grad`` of the reference's blocked online softmax
    (``_blocked_attn``) at nemotron's head dim, GQA 12 (12 query heads on
    one KV head), L 40, at atol 2e-5, rtol 1e-5; non-causal as the
    reference's scan with a key offset past every key."""
    b, L, h, kvh, d = 2, 40, 12, 1, 192
    rng = np.random.default_rng(192 + causal)
    q, do = (rng.standard_normal((b, L, h, d), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, L, kvh, d), dtype=np.float32)
            for _ in range(2))
    scale = d ** -0.5

    def jattention(jq, jk, jv):
        out = jattn._blocked_attn(jq.reshape(b, L, kvh, h // kvh, d),
                                  lambda j: (jk, jv), 1, L, 0, scale,
                                  0 if causal else L)
        return out.reshape(b, L, h, d)

    want = jax.grad(lambda *a: jnp.sum(jattention(*a) * do),
                    argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, scale=scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(jattention(q, k, v)),
                               atol=1e-5, rtol=1e-5)
    lse = (ref.flash_attention_lse_ref(tq, tk, causal=causal, scale=scale)
           if form == "lse" else None)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal,
                                      scale=scale, lse=lse)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5, err_msg=name)


def test_head_dim_192_takes_the_wgmma_routes():
    """bf16 at D 192 takes the wgmma forward (nemotron's serving prefill
    and training forward, which writes the log-sum-exp) and the wgmma
    backward, in three launches (dq, dv, dk); float32 there takes the
    tf32x3 forward and the tf32x3 backward, in three launches too."""
    bf16, f32 = torch.bfloat16, torch.float32
    for lq in (2, 130, 4096):
        assert fa.route(bf16, 1, lq, lq, 96, 8, 192, True) == "wgmma"
        assert fa.route(bf16, 1, lq, lq, 96, 8, 192, False) == "wgmma"
        assert fa.route_bwd(bf16, lq, 192) == "wgmma"
        assert fa.bwd_launches(bf16, lq, 192) == 3
        assert fa.route(f32, 1, lq, lq, 96, 8, 192, True) == "tf32x3"
        assert fa.route_bwd(f32, lq, 192) == "tf32x3"
    assert fa.route(bf16, 1, 1, 4096, 96, 8, 192, True) == "decode"
    assert 192 in fa.bwd_head_dims("wgmma")
    assert 192 in fa.bwd_head_dims("tf32x3")
    assert 192 in fa.bwd_head_dims("simt")
    assert fa.BWD_HEAD_DIMS == (16, 32, 64, 80, 96, 128, 192)
    assert fa.bwd_launches(bf16, 4096, 128) == 2


@pytest.mark.parametrize("lq", [2, 200, 4096])
def test_float32_head_dim_192_takes_the_split_simt_backward(lq):
    """float32 at D 192 takes the tf32x3 backward in three launches (dq,
    then dv and dk apart: their fused launch would pass what a thread's
    registers hold), as bf16 there takes the wgmma one; the dk/dv wrappers
    of every route take one part at 192 and both below it, and refuse the
    other form before any launch."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert fa.route_bwd(f32, lq, 192) == "tf32x3"
    assert fa.bwd_launches(f32, lq, 192) == 3
    assert fa.bwd_launches(f32, lq, 128) == 2
    assert fa.bwd_launches(bf16, lq, 192) == 3
    assert fa.SPLIT_DKDV_HEAD_DIMS == (192,)
    fa._check_part(fa._DV, 192, "k")
    fa._check_part(fa._DK, 192, "k")
    fa._check_part(fa._DKDV, 128, "k")
    with pytest.raises(ValueError, match="two launches"):
        fa._check_part(fa._DKDV, 192, "k")
    with pytest.raises(ValueError, match="one launch"):
        fa._check_part(fa._DK, 128, "k")


def test_golden_cuts_are_the_smokes():
    """The golden script's new entries are the models ``chip_smoke.py``
    checks and trains: the ``"train_families"`` nemotron cut and the
    ``"dense"`` one at the smoke's nemotron training width
    (``TRAIN_FAMILY_CUTS``) in depth 2 with the MoE entries' vocabulary,
    musicgen at full width; the golden file's entries carry exactly the
    script's cuts (float32), and every arch of the registry has a golden
    entry that the card checks."""
    import importlib.util
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "scripts"))
    import make_torch_golden as mg
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = smoke.TRAIN_FAMILY_CUTS["nemotron-4-340b"]
    for cuts in (mg.TRAIN_FAMILY_CUTS, mg.DENSE_CUTS):
        nem = cuts["nemotron"]
        assert nem["arch"] == "nemotron-4-340b"
        assert (nem["d_model"], nem["d_ff"]) == (card["d_model"],
                                                card["d_ff"])
        assert nem["num_layers"] == 2 and nem["vocab_size"] == 32768
    assert mg.TRAIN_FAMILY_CUTS["musicgen"] == dict(
        arch=smoke.AUDIO_ARCH, num_layers=2)
    assert mg.AUDIO_CUTS == {"musicgen": dict(arch=smoke.AUDIO_ARCH,
                                              num_layers=2)}
    assert set(smoke.DENSE_MAIN) == {mg.DENSE_CUTS[n]["arch"]
                                     for n in ("qwen", "command_r")}
    with open(os.path.join(root, "tests", "data",
                           "torch_port_golden.json")) as f:
        golden = json.load(f)
    checked = {golden["lm"]["arch"]}
    for entry, cuts in (("dense", mg.DENSE_CUTS), ("audio", mg.AUDIO_CUTS),
                        ("train_families", mg.TRAIN_FAMILY_CUTS)):
        assert set(golden[entry]) == set(cuts), entry
        for name, cut in cuts.items():
            assert golden[entry][name]["cuts"] == dict(cut, dtype="float32")
            checked.add(cut["arch"])
    for entry in ("moe", "ssm", "vlm"):
        checked |= {g["arch"] for g in golden[entry].values()}
    assert checked == set(registry.ARCHS)
    assert golden["audio"]["musicgen"]["num_layers"] == 2
    assert np.asarray(golden["audio"]["musicgen"]["prompt"]).shape == (
        2, 4, 64)
