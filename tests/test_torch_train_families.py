"""Training of every family against the reference, on the CPU: the
forward and gradient of each arch's smoke config, the gradient leaves of
the MoE, MLA, SSD and hybrid families against ``jax.value_and_grad`` with
remat on and off, training checkpoints that each package restores from
the other's, and the refusal of a head dim that no backward kernel takes.

The families that `train.step.check_trainable` still refuses are driven
through `model.loss_fn` directly (as the reference's own smoke test drives
its ``loss_fn``): what is checked is that their gradients are right, not
that the launcher trains them.  Gradient leaves are held at the
tolerances of ``tests/test_torch_train.py``'s leaf test (atol 1e-6 +
rtol 1e-5) on the same weights (`convert.lm_params_from_jax`) and
batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import model
from repro_torch.train import loop
from repro_torch.train.step import check_trainable

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
    """nemotron-4-340b's head dim 192 has no backward kernel: refused up
    front on a CUDA device, not at the first backward; the CPU (the plain
    version) and the other dense archs pass."""
    nemotron = registry.get("nemotron-4-340b")
    with pytest.raises(NotImplementedError, match="head dim 192"):
        check_trainable(nemotron, torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="head dim 192"):
        check_trainable(nemotron, "cuda:0")
    check_trainable(nemotron, "cpu")
    check_trainable(nemotron)
    for arch in ("llama3.2-3b", "qwen1.5-110b", "phi-3-vision-4.2b",
                 "musicgen-medium"):
        check_trainable(registry.get(arch), "cuda")
