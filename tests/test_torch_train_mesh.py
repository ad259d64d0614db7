"""Port ≡ reference for sharded training (`distributed.fsdp`,
`train.step.make_train_step(mesh=)`, `launch.train --mesh`) on dense, SSD
and hybrid models.

Two float32 steps of 8 × 256 tokens on a 2×2 gloo world of 4 CPU ranks
(`torch_mesh_workers.train_mesh_world`, which runs the card's rank
program `launch.mesh_smoke.rank_train_mesh`), against the reference's
own sharded step (``jax.jit(make_train_step)`` on parameters placed by
its ``param_shardings`` under ``set_mesh``) on 4 forced host devices in
a subprocess (``scripts/make_torch_golden.py --train-mesh-worker``):
llama3.2-3b in 2 microbatches, zamba2 and mamba2 in 1 (the gradient in
the parameters' dtype).  Losses and grad norms agree within 1e-4
relative, every leaf after the steps within 1e-3 relative L2 (the limit
of the ``"train_families"`` golden); each rank holds only its shards of
the parameters, moments and gradient accumulators; the grad norm is the
one-device step's; step 0's gradient gathered from the shards is the
one-device gradient (llama and maverick smoke, the card's full-width
check); `Mesh.reduce_scatter` is an all-reduce and a slice; and the
launcher on a 2×2 gloo mesh trains as it does on one device."""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import accel, mesh_smoke
from repro_torch.launch import train as tlaunch
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import make_torch_golden as golden  # noqa: E402

torch.set_num_threads(1)

JOBS = [golden.train_mesh_job("llama", full=True),
        golden.train_mesh_job("zamba2", full=True, microbatches=1),
        golden.train_mesh_job(
            "mamba2", full=True, arch="mamba2-1.3b", shape=[2, 2],
            microbatches=1, leaves=["embedding", "layers.0.mamba.in_proj",
                                    "layers.1.mamba.out_proj"])]
NAMES = [job["name"] for job in JOBS]
STEP_TOL, LEAF_TOL = 1e-4, 1e-3
# The card's [train mesh shards] / [train mesh grads] check on smoke
# configs in float32 (maverick's MoE on its scatter route, as there): the
# gathered gradient's limit, the control's floor.
SHARD_ARCHS = ["llama3.2-3b", "llama4-maverick-400b-a17b"]
SHARD_CUTS = [{}, {"moe_impl": "scatter"}]
GRAD_TOL, CONTROL_FLOOR = 1e-5, 0.5


@functools.lru_cache(maxsize=None)
def _world() -> list:
    return accel.spawn(workers.train_mesh_world, 4, args=(
        JOBS, [(dataclasses.replace(registry.smoke(a), **c), (4, 64))
               for a, c in zip(SHARD_ARCHS, SHARD_CUTS)]),
        device="cpu", timeout_s=600)


@functools.lru_cache(maxsize=None)
def _reference() -> list:
    return golden.train_mesh_reference_subprocess(JOBS)


def _rel(got, want) -> float:
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("i", range(len(JOBS)), ids=NAMES)
def test_sharded_steps_match_the_references_sharded_step(i):
    want = _reference()[i]
    ranks = [r["jobs"][i] for r in _world()]
    for r in ranks:
        assert r["steps"] == ranks[0]["steps"]        # every rank agrees
    for got, ref in zip(ranks[0]["steps"], want["steps"]):
        for key in ("loss", "grad_norm"):
            assert _rel(got[key], ref[key]) <= STEP_TOL, (key, got, ref)
    leaves = ranks[0]["leaves"]
    assert set(leaves) == set(want["leaves"])
    for name, ref in want["leaves"].items():
        ref = np.asarray(ref, np.float32)
        diff = np.linalg.norm(leaves[name] - ref)
        assert diff <= LEAF_TOL * np.linalg.norm(ref), name


@pytest.mark.parametrize("i", range(len(JOBS)), ids=NAMES)
def test_each_rank_holds_only_its_shards(i):
    """Parameters, both moments and the float32 (M > 1) or parameter-dtype
    (M = 1) accumulators take exactly the bytes of the rank's slices,
    a quarter of the whole model's or more where a leaf is replicated,
    and never all of it."""
    for r in _world():
        b = r["jobs"][i]["bytes"]
        assert b["params"] == b["m"] == b["v"] == b["shards"]
        assert b["accumulators"] == b["accumulators_want"]
        assert b["whole"] / 4 <= b["shards"] < b["whole"] / 2


def test_the_grad_norm_is_the_one_device_norm():
    """llama's sharded step (2x2, 2 microbatches) against the port's own
    one-device step on the same weights and batches."""
    job = JOBS[0]
    cfg, tree = mesh_smoke.train_mesh_cfg(job)
    params = model.trainable(convert.lm_params_from_jax(tree, cfg, "cpu"))
    data = SyntheticLM(cfg, job["batch"], job["seq"], seed=job["data_seed"])
    step = make_train_step(cfg, lambda s: job["lr"], job["microbatches"])
    opt = adamw.init(params)
    sharded = _world()[0]["jobs"][0]["steps"]
    for s, got in enumerate(sharded):
        b = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in data.batch_at(s).items()}
        params, opt, m = step(params, opt, b)
        assert _rel(got["grad_norm"], float(m["grad_norm"])) <= 1e-5
        assert _rel(got["loss"], float(m["loss"])) <= 1e-5


@pytest.mark.parametrize("i", range(len(SHARD_ARCHS)), ids=SHARD_ARCHS)
def test_the_gathered_gradient_is_the_one_device_gradient(i):
    """`mesh_smoke.rank_shard_init` with its gradient check (the card's
    full-width check, here on the smoke config): every rank's sharded
    draw is the one-device draw's slices, and step 0's gradient gathered
    from the shards equals the one-device autograd gradient in every
    leaf, while the same gradient with a block rolled onto its
    neighbour's slice (the control) does not."""
    for r in _world():
        check = r["shards"]["checks"][i]
        assert check["differ"] == []
        assert np.isfinite(check["grads"]["loss"])
    g = _world()[0]["shards"]["checks"][i]["grads"]
    assert g["leaves"] == _world()[0]["shards"]["checks"][i]["leaves"]
    assert g["err"] <= GRAD_TOL, g
    assert g["control"] >= CONTROL_FLOOR, g
    assert _rel(g["loss"], g["one_device_loss"]) <= STEP_TOL


@pytest.mark.parametrize("axis", ["data", "model"])
def test_reduce_scatter_is_an_all_reduce_and_a_slice(axis):
    for r in _world():
        got, want, calls = r["reduce_scatter"][axis]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert calls > 0


def test_the_launcher_trains_on_a_2x2_gloo_mesh_as_on_one_device(capsys):
    argv = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
            "--steps", "3"]
    one = tlaunch.main(argv)
    mesh = tlaunch.main(argv + ["--mesh", "2x2", "--backend", "gloo"])
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=1e-4)
    np.testing.assert_allclose(mesh["grad_norms"], one["grad_norms"],
                               rtol=1e-4)
    assert mesh["rank_losses"] == [mesh["losses"]] * 4
    assert mesh["backend"] == "gloo" and len(mesh["rank_peak_gib"]) == 4
    assert set(mesh["mesh_stats"]) == {"data", "model"}
    assert "2x2 mesh of gloo ranks" in capsys.readouterr().out
