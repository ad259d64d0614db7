"""Port ≡ reference for the LM substrate's training: the loss, AdamW, the
train step, the data pipeline, checkpoints of the training state, the
fault-tolerant loop and the launcher.

The port's training path is held against live ``repro`` on the same
weights (the reference's ``init_params`` tree carried across by
`convert.lm_params_from_jax`) and the same batches, in float32 on the CPU,
where attention's forward and gradient run the flash kernels' plain
versions.  Tolerances: the loss within 1e-5 relative; each gradient leaf
within atol 1e-6 + rtol 1e-5 (measured: 3e-8 at most, the order of
float32 sums); parameters after AdamW steps within atol 2e-5, the
reference's own microbatch tolerance (an element whose gradient is ~1e-8
moves by lr · g / (|g| + eps), where float32 rounding of g shows).
`SyntheticLM` batches are bit-identical.  The reference's own training,
pipeline, checkpoint and crash/restart tests (``tests/
test_train_substrate.py``, ``tests/test_fault_tolerance.py``) are re-run
on the port below them, the checkpoint ones on a ``(params, AdamWState)``
tree."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import registry as jregistry
from repro.data import pipeline as jpipeline
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import registry
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import common, model
from repro_torch.models.config import SHAPES, LONG_CONTEXT_FAMILIES
from repro_torch.optim import adamw
from repro_torch.train import loop
from repro_torch.train.step import make_train_step

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

TRAIN_ARCHS = ["llama3.2-3b", "phi-3-vision-4.2b", "musicgen-medium"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, seed=0):
    """(reference config, port config, reference params, the same weights
    in a trainable port model)."""
    jc, tc = jregistry.smoke(arch), registry.smoke(arch)
    jp = jmodel.init_params(jax.random.key(seed), jc)
    tp = model.trainable(convert.lm_params_from_jax(_np(jp), tc,
                                                    device="cpu"))
    return jc, tc, jp, tp


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def _leaves_close(got: dict, want_tree, cfg, atol, rtol=0.0):
    """Each port leaf of ``got`` against the reference tree's leaf of the
    same name."""
    want = convert.lm_named_leaves(_np(want_tree), cfg)
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


# ------------------------------------------------------------------- config
def test_shapes_equal_the_reference():
    from repro.models import config as jconfig
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert LONG_CONTEXT_FAMILIES == jconfig.LONG_CONTEXT_FAMILIES


@dataclasses.dataclass
class _Spec:
    """A reference leaf's shape and dtype; indexing drops the group axis."""
    shape: tuple
    dtype: object

    def __getitem__(self, g):
        return _Spec(self.shape[1:], self.dtype)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_param_shapes_allocate_nothing_and_match_the_reference(arch):
    skel = model.param_shapes(registry.get(arch))
    want = convert.lm_named_leaves(
        jax.tree.map(lambda s: _Spec(s.shape, s.dtype),
                     jmodel.param_shapes(jregistry.get(arch))),
        registry.get(arch))
    got = dict(skel.named_parameters())
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).split(".")[1] == str(want[name].dtype), name


# --------------------------------------------------------------------- loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_loss_and_its_gradient(z_loss):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 3, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9, 3)).astype(np.int32)
    labels[0, :4] = -1                        # ignored positions
    want, want_g = jax.value_and_grad(
        lambda x: jcommon.cross_entropy_loss(x, jnp.asarray(labels),
                                             z_loss=z_loss))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = common.cross_entropy_loss(x, torch.from_numpy(labels),
                                    z_loss=z_loss)
    (g,) = torch.autograd.grad(got, [x])
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), atol=1e-7,
                               rtol=1e-5)


def test_cross_entropy_of_only_ignored_labels_is_zero():
    got = common.cross_entropy_loss(torch.zeros(2, 5, 7),
                                    torch.full((2, 5), -1))
    assert float(got) == 0.0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_fn_and_every_gradient_leaf(arch):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` against
    autograd of the port's (phi-3-vision: patches with label -1; musicgen:
    the codebook swap)."""
    jc, tc, jp, tp = _setup(arch)
    b = jpipeline.SyntheticLM(jc, 4, 32, seed=1).batch_at(0)
    (want, aux), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jc, b), has_aux=True))(jp, _jbatch(b))
    got, parts = model.loss_fn(tp, tc, _tbatch(b))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(parts["ce"].detach()) == pytest.approx(float(aux["ce"]),
                                                        rel=1e-5)
    assert float(parts["aux"]) == float(aux["aux"]) == 0.0
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(got, list(named.values()))
    _leaves_close(dict(zip(named, grads)), want_g, tc, atol=1e-6, rtol=1e-5)


def test_remat_changes_no_gradient_and_serving_never_checkpoints(
        monkeypatch):
    _, tc, _, tp = _setup("llama3.2-3b")
    b = _tbatch(SyntheticLM(tc, 2, 32, seed=0).batch_at(0))
    calls = []
    real = model.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(model, "checkpoint", spy)
    named = dict(tp.named_parameters())
    g_remat = torch.autograd.grad(model.loss_fn(tp, tc, b)[0],
                                  list(named.values()))
    assert len(calls) == tc.num_layers
    plain = dataclasses.replace(tc, remat=False)
    g_plain = torch.autograd.grad(model.loss_fn(tp, plain, b)[0],
                                  list(named.values()))
    for a, c in zip(g_remat, g_plain):
        torch.testing.assert_close(a, c, atol=0, rtol=0)
    with torch.no_grad():
        model.loss_fn(tp, tc, b)
    model.forward(tp, tc, b)
    assert len(calls) == tc.num_layers


# ------------------------------------------------------------------- AdamW
def _tree(rng, dtype):
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": (rng.standard_normal(7) * 1e-3).astype(np.float32)},
            "d": rng.standard_normal(4).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(param_dtype, state_dtype):
    """Three steps on the same trees (a gradient with a tiny leaf, clipped
    at max norm 1), bf16 leaves and bf16 moments included: parameters,
    moments, step and grad norm."""
    rng = np.random.default_rng(5)
    jdt, tdt = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    sdt = getattr(torch, state_dtype)
    p0 = _tree(rng, param_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = {k: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))).to(tdt)
          for k, v in _flat(_np(jp)).items()}
    jo = jadamw.init(jp, getattr(jnp, state_dtype))
    to = adamw.init(tp, sdt)
    for i in range(3):
        g = _tree(rng, param_dtype)
        jg = jax.tree.map(lambda a: jnp.asarray(a * 3, jdt), g)
        tg = {k: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))
                                  ).to(tdt)
              for k, v in _flat(_np(jg)).items()}
        jp, jo, jn = jadamw.update(jp, jg, jo, lr=jnp.float32(1e-2 * (i + 1)))
        tp, to, tn = adamw.update(tp, tg, to, lr=torch.tensor(1e-2 * (i + 1)))
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert int(to.step) == int(jo.step) == 3 and to.step.dtype == torch.int32
    tol = 1e-6 if param_dtype == state_dtype == "float32" else 1e-2
    for got, want in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        want = _flat(_np(want))
        for k, t in got.items():
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(want[k], np.float32),
                atol=tol, rtol=tol, err_msg=k)
    assert all(t.dtype == tdt for t in tp.values())
    assert all(t.dtype == sdt for t in to.m.values())


def test_clip_and_global_norm_match_the_reference():
    rng = np.random.default_rng(9)
    g = _tree(rng, "float32")
    want, wn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    got, n = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in _flat(g).items()}, 0.5)
    assert float(n) == pytest.approx(float(wn), rel=1e-6)
    for k, v in _flat(_np(want)).items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6)


def test_cosine_schedule_matches_the_reference():
    want = jadamw.cosine_schedule(3e-4, 10, 100)
    got = adamw.cosine_schedule(3e-4, 10, 100)
    for s in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 250):
        assert float(got(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(want(jnp.int32(s))), rel=1e-6, abs=1e-12)


def test_adamw_state_carried_from_the_reference():
    jc, tc, jp, tp = _setup("llama3.2-3b")
    b = jpipeline.SyntheticLM(jc, 2, 16, seed=0).batch_at(0)
    _, jo, _ = jax.jit(jstep.make_train_step(jc, lambda s: 1e-3))(
        jp, jadamw.init(jp), _jbatch(b))
    to = convert.adamw_state_from_jax(jo, tc, device="cpu")
    assert int(to.step) == 1 and set(to.m) == set(dict(tp.named_parameters()))
    _leaves_close(to.m, jo.m, tc, atol=0)
    _leaves_close(to.v, jo.v, tc, atol=0)


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_steps_match_the_reference(microbatches):
    """Two steps of ``make_train_step`` (cosine lr, no warmup) from the
    same weights on the same batches: loss, grad norm, lr, parameters and
    moments."""
    jc, tc, jp, tp = _setup("llama3.2-3b")
    lr = (jadamw.cosine_schedule(1e-3, 0, 10),
          adamw.cosine_schedule(1e-3, 0, 10))
    jfn = jax.jit(jstep.make_train_step(jc, lr[0], microbatches))
    tfn = make_train_step(tc, lr[1], microbatches)
    jo, to = jadamw.init(jp), adamw.init(tp)
    data = jpipeline.SyntheticLM(jc, 8, 32, seed=2)
    for step in range(2):
        b = data.batch_at(step)
        jp, jo, jm = jfn(jp, jo, _jbatch(b))
        tp, to, tm = tfn(tp, to, _tbatch(b))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _leaves_close(dict(tp.named_parameters()), jp, tc, atol=2e-5)
    _leaves_close(to.m, jo.m, tc, atol=1e-6)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_synthetic_batches_are_bit_identical(arch):
    jc, tc = jregistry.smoke(arch), registry.smoke(arch)
    for step in (0, 7):
        want = jpipeline.SyntheticLM(jc, 3, 24, seed=4).batch_at(step)
        got = SyntheticLM(tc, 3, 24, seed=4).batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------- checkpointing
def _state_tree():
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "layers.0.b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    opt = adamw.init(params)
    opt = adamw.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                           m={k: v.float() + 1 for k, v in params.items()},
                           v=opt.v)
    return params, opt


def test_checkpoint_of_the_training_state_round_trips(tmp_path):
    tree = _state_tree()
    ckpt.save(str(tmp_path), 3, tree)
    (params, opt), step = ckpt.restore(str(tmp_path), tree)
    assert step == 3 and isinstance(opt, adamw.AdamWState)
    for a, b in zip(ckpt._flatten(tree)[1], ckpt._flatten((params, opt))[1]):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    paths = [e["path"] for e in ckpt.read_manifest(str(tmp_path))["leaves"]]
    assert paths == ["0/layers.0.b", "0/w", "1/.step", "1/.m/layers.0.b",
                     "1/.m/w", "1/.v/layers.0.b", "1/.v/w"]


def test_training_state_paths_are_the_references(tmp_path):
    """A dataclass flattens as jax flattens a registered dataclass."""
    params = {"w": np.ones((2, 3), np.float32), "b": np.zeros(2, np.float32)}
    jo = jadamw.init(jax.tree.map(jnp.asarray, params))
    to = adamw.init({k: torch.from_numpy(v) for k, v in params.items()})
    jckpt.save(str(tmp_path / "ref"), 1, (params, jo))
    ckpt.save(str(tmp_path / "port"), 1, (params, to))
    want = jckpt.read_manifest(str(tmp_path / "ref"))["leaves"]
    got = ckpt.read_manifest(str(tmp_path / "port"))["leaves"]
    assert got == want


def test_pool_snapshot_bytes_are_unchanged(tmp_path):
    """A sketch pool's snapshot tree (`SketchStore._tree`'s leaves) saved
    by either package: every file byte for byte equal."""
    rng = np.random.default_rng(0)
    tree = {"visited": rng.integers(0, 2 ** 32, (2, 64, 2), dtype=np.uint32),
            "roots": rng.integers(0, 64, (2, 64)).astype(np.int32),
            "batch_indices": np.arange(2, dtype=np.int64),
            "batch_epochs": np.zeros(2, np.int64),
            "edge_visits": np.full((2, 2), -1, np.int64),
            "counters": np.asarray([1, 2, 0, 64, 0], np.int64)}
    extra = {"kind": "sketch_pool"}
    jckpt.save(str(tmp_path / "ref"), 1, tree, extra=extra)
    ckpt.save(str(tmp_path / "port"), 1, tree, extra=extra)
    ref_dir = tmp_path / "ref" / "step_00000001"
    port_dir = tmp_path / "port" / "step_00000001"
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir)) and len(names) == 7
    for name in names:
        assert (ref_dir / name).read_bytes() == \
            (port_dir / name).read_bytes(), name


def test_checkpoint_keeps_last_k(tmp_path):
    tree = _state_tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2


def test_checkpoint_async(tmp_path):
    tree = _state_tree()
    t = ckpt.save(str(tmp_path), 1, tree, blocking=False)
    t.join()
    (params, opt), _ = ckpt.restore(str(tmp_path), tree)
    torch.testing.assert_close(opt.m["w"], tree[1].m["w"])
    assert int(opt.step) == 7


def test_checkpoint_ignores_partial_tmp(tmp_path):
    ckpt.save(str(tmp_path), 1, _state_tree())
    os.makedirs(tmp_path / "step_00000002.tmp")      # simulated dead writer
    assert ckpt.latest_step(str(tmp_path)) == 1


# ------------------------------------- the reference's own tests, on the port
def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0], requires_grad=True)}
    opt = adamw.init(params)
    for _ in range(200):
        (g,) = torch.autograd.grad(params["w"].square().sum(),
                                   [params["w"]])
        params, opt, _ = adamw.update(params, {"w": g}, opt, lr=0.1,
                                      weight_decay=0.0)
    assert float(params["w"].detach().abs().max()) < 1e-2


def test_grad_clip():
    grads = {"a": torch.full((4,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert abs(float(adamw.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(200.0)


def test_cosine_schedule_shape():
    lr = adamw.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1e-3)
    assert float(lr(100)) == pytest.approx(1e-4, rel=0.01)
    assert float(lr(55)) < float(lr(20))


def test_pipeline_deterministic_by_step():
    cfg = registry.smoke("llama3.2-3b")
    d1 = SyntheticLM(cfg, 4, 32, seed=7)
    d2 = SyntheticLM(cfg, 4, 32, seed=7)
    b1, b2 = d1.batch_at(13), d2.batch_at(13)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], d1.batch_at(14)["tokens"])


def test_pipeline_labels_shifted():
    cfg = registry.smoke("llama3.2-3b")
    b = SyntheticLM(cfg, 2, 16, seed=0).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_order_and_resume():
    cfg = registry.smoke("llama3.2-3b")
    src = SyntheticLM(cfg, 2, 16, seed=3)
    pf = Prefetcher(src, start_step=5)
    try:
        for expect in (5, 6, 7):
            step, batch = pf.get()
            assert step == expect
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(expect)["tokens"])
    finally:
        pf.close()


def test_train_step_reduces_loss():
    cfg = registry.smoke("llama3.2-3b")
    params = model.trainable(model.init_params(cfg, 0, "cpu"))
    opt = adamw.init(params)
    data = SyntheticLM(cfg, 8, 32, seed=1)
    step_fn = make_train_step(cfg, lambda s: 1e-3)
    first = last = None
    for step in range(30):
        params, opt, m = step_fn(params, opt, _tbatch(data.batch_at(step)))
        if step == 0:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first - 0.5, (first, last)


def test_microbatched_grads_match_full_batch():
    """The reference hands both steps the same (immutable) trees; the
    port's update writes in place, so each step gets its own copy."""
    cfg = registry.smoke("llama3.2-3b")
    params = model.trainable(model.init_params(cfg, 0, "cpu"))
    b = _tbatch(SyntheticLM(cfg, 8, 32, seed=2).batch_at(0))
    p1, p2 = copy.deepcopy(params), copy.deepcopy(params)
    p1, _, m1 = make_train_step(cfg, lambda s: 1e-3, 1)(p1, adamw.init(p1), b)
    p2, _, m2 = make_train_step(cfg, lambda s: 1e-3, 4)(p2, adamw.init(p2), b)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, c in zip(p1.parameters(), p2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   atol=2e-5)


def test_crash_restart_matches_uninterrupted(tmp_path):
    cfg = registry.smoke("llama3.2-3b")
    kw = dict(batch=4, seq_len=32, steps=12, ckpt_every=4, lr=1e-3,
              log_every=100, print_fn=lambda *a: None, async_ckpt=False,
              device="cpu")
    clean = loop.train(cfg, checkpoint_dir=str(tmp_path / "clean"), **kw)
    crashed = loop.train_with_restarts(
        cfg, checkpoint_dir=str(tmp_path / "crashy"),
        crash_schedule=(5, 9), **kw)
    assert crashed.resumed_from is not None
    for a, b in zip(clean.params.parameters(), crashed.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


def test_restart_resumes_data_cursor(tmp_path):
    """Losses after resume equal the tail of the uninterrupted run — the
    data cursor (== step) restores exactly."""
    cfg = registry.smoke("llama3.2-3b")
    kw = dict(batch=4, seq_len=32, steps=10, ckpt_every=2, lr=1e-3,
              log_every=100, print_fn=lambda *a: None, async_ckpt=False,
              device="cpu")
    clean = loop.train(cfg, checkpoint_dir=str(tmp_path / "c2"), **kw)
    crashed = loop.train_with_restarts(
        cfg, checkpoint_dir=str(tmp_path / "d2"), crash_schedule=(5,), **kw)
    np.testing.assert_allclose(clean.losses[-crashed.steps_run:],
                               crashed.losses, atol=1e-5)


# ---------------------------------------------------------------- launcher
def test_launcher_trains_the_smoke_config_on_cpu(capsys):
    out = tlaunch.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                        "cpu", "--steps", "5", "--microbatches", "2"])
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    assert out["batch"] == 8 and out["seq_len"] == 64
    assert out["peak_gib"] is None and len(out["step_seconds"]) == 5
    assert set(out["clock"]) == {"forward", "backward", "optimizer"}
    assert "[launch.train] llama3.2-3b-smoke" in capsys.readouterr().out


def test_launcher_refuses_a_mesh_and_needs_a_gpu_by_default(monkeypatch):
    """A batch whose rows do not split over the mesh's ranks is refused
    before any rank starts (8 rows over the 6 ranks of 2x3), naming the
    rows and the mesh; without a GPU the default device raises."""
    from repro_torch.launch import accel

    def no_spawn(*a, **k):
        raise AssertionError("a rank started")

    monkeypatch.setattr(accel, "spawn", no_spawn)
    with pytest.raises(ValueError, match=r"batch of 8 rows.*mesh 2x3"):
        tlaunch.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                      "--mesh", "2x3", "--backend", "gloo"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tlaunch.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1"])
