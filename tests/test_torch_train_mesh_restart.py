"""The restart contract of sharded training (`train.loop.train(mesh=)`)
on a 2×2 gloo world of 4 CPU ranks (`torch_mesh_workers.
train_restart_world`), the smoke llama, 4 steps of 8 × 32 tokens
checkpointed every step.

A sharded run crashed after step 2 and restarted ends bit-identical to
an uninterrupted one.  Its checkpoint is the file a one-device run
writes (rank 0 gathers every leaf): the reference's loop resumes from it
(``repro.checkpoint.manager.restore`` into its own tree) with the
sharded run's parameters and moments, and a one-device port run resumes
from its step 2 and ends where the sharded run ends; a sharded run
resumes from a one-device run's step-2 checkpoint the same way."""
import functools
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro.configs import registry as jregistry
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import accel
from repro_torch.train import loop

torch.set_num_threads(1)

ARCH = "llama3.2-3b"
CLOSE = dict(rtol=2e-5, atol=2e-6)      # sharded against one device


@functools.lru_cache(maxsize=None)
def _world() -> tuple[str, list]:
    """(the checkpoint root, the ranks' results); the one-device
    checkpoint at step 2 is written before the ranks start."""
    root = tempfile.mkdtemp(prefix="repro_torch_restart_")
    kw = dict(workers.RESTART_KW, steps=2, ckpt_every=2, async_ckpt=False)
    loop.train(registry.smoke(ARCH), checkpoint_dir=os.path.join(root, "one"),
               device="cpu", **kw)
    return root, accel.spawn(workers.train_restart_world, 4, args=(root,),
                             device="cpu", timeout_s=600)


def _state(run: str) -> dict:
    return _world()[1][0][run]["state"]


def _copy_at(run: str, step: int, dest) -> str:
    """The run's checkpoint directory with its checkpoints past ``step``
    left out."""
    src = os.path.join(_world()[0], run)
    shutil.copytree(src, dest)
    for d in os.listdir(dest):
        if d.startswith("step_") and int(d.split("_")[1]) > step:
            shutil.rmtree(os.path.join(dest, d))
    return str(dest)


def test_a_crashed_sharded_run_restarts_bit_identically():
    ranks = _world()[1]
    clean, crashed = ranks[0]["clean"], ranks[0]["crashed"]
    assert crashed["resumed_from"] == 2 and clean["resumed_from"] is None
    assert crashed["losses"] == clean["losses"][2:]
    assert crashed["step"] == clean["step"] == 4
    for name, want in clean["state"].items():
        np.testing.assert_array_equal(crashed["state"][name], want,
                                      err_msg=name)
    for r in ranks:
        assert r["crashed"]["losses"] == crashed["losses"]


def test_the_reference_resumes_from_a_sharded_checkpoint(tmp_path):
    d = _copy_at("clean", 4, tmp_path / "ckpt")
    ref = jloop.train(jregistry.smoke(ARCH), checkpoint_dir=d,
                      **workers.RESTART_KW)
    assert ref.resumed_from == 4 and ref.steps_run == 0
    cfg = registry.smoke(ARCH)
    state = _state("clean")
    for what, tree in (("params", ref.params), ("m", ref.opt_state.m),
                       ("v", ref.opt_state.v)):
        for name, a in convert.lm_named_leaves(tree, cfg).items():
            np.testing.assert_array_equal(np.asarray(a),
                                          state[f"{what}/{name}"],
                                          err_msg=name)


def test_one_device_resumes_from_a_sharded_checkpoint(tmp_path):
    d = _copy_at("clean", 2, tmp_path / "ckpt")
    res = loop.train(registry.smoke(ARCH), checkpoint_dir=d, device="cpu",
                     **workers.RESTART_KW)
    assert res.resumed_from == 2 and res.steps_run == 2
    state = _state("clean")
    np.testing.assert_allclose(res.losses, _world()[1][0]["clean"][
        "losses"][2:], **CLOSE)
    for name, t in res.params.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(),
                                   state[f"params/{name}"], **CLOSE,
                                   err_msg=name)


@pytest.mark.parametrize("what", ["params", "m", "v"])
def test_a_sharded_run_resumes_from_a_one_device_checkpoint(what):
    """``from_one`` resumed the one-device run's step 2 on the mesh and
    ends where the sharded run that began on the mesh ends."""
    run = _world()[1][0]["from_one"]
    assert run["resumed_from"] == 2 and run["step"] == 4
    np.testing.assert_allclose(run["losses"], _world()[1][0]["clean"][
        "losses"][2:], **CLOSE)
    for name, want in _state("clean").items():
        if name.startswith(what + "/"):
            np.testing.assert_allclose(run["state"][name], want, **CLOSE,
                                       err_msg=name)
