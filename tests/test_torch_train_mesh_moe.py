"""Port ≡ reference for sharded training of the MoE models: deepseek-v3
(MLA and the expert-parallel a2a dispatch) on a 2×2 mesh and maverick on
a data-only mesh of 4 (the scatter's global dispatch), each two float32
steps of 8 × 256 tokens in 2 microbatches on 4 gloo CPU ranks
(`torch_mesh_workers.train_mesh_world`) against the reference's own
sharded step on 4 forced host devices in a subprocess
(``scripts/make_torch_golden.py --train-mesh-worker``).

Every expert pick of every MoE call (each microbatch's forward, both
steps) equals the reference's, gathered from the ranks into the
microbatch's token order: on the a2a route rank (d, m) routes the
reference's block (data rank d's rows, sequence block m), on the scatter
route rank q its own rows.  Losses and grad norms agree within 1e-4
relative, every leaf within 1e-3 relative L2.  On the a2a route each
rank runs only its E/S experts, and the capacity is the reference's
block-local one (so the step differs from the one-device step, which
the scatter matches)."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro_torch import convert
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import accel, mesh_smoke
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import make_torch_golden as golden  # noqa: E402

torch.set_num_threads(1)

JOBS = [golden.train_mesh_job("deepseek", full=True),
        golden.train_mesh_job("maverick", full=True)]
NAMES = [job["name"] for job in JOBS]
STEP_TOL, LEAF_TOL = 1e-4, 1e-3


@functools.lru_cache(maxsize=None)
def _world() -> list:
    return accel.spawn(workers.train_mesh_world, 4, args=(JOBS,),
                       device="cpu", timeout_s=600)


@functools.lru_cache(maxsize=None)
def _reference() -> list:
    return golden.train_mesh_reference_subprocess(JOBS)


def _rel(got, want) -> float:
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("i", range(len(JOBS)), ids=NAMES)
def test_every_expert_pick_is_the_references(i):
    want = _reference()[i]["routes"]
    got = _world()[0]["jobs"][i]["routes"]
    cfg, _ = mesh_smoke.train_mesh_cfg(JOBS[i])
    moe_layers = sum(k == "moe" for k in model.layer_kinds(cfg))
    assert len(want) == JOBS[i]["num_steps"] * JOBS[i]["microbatches"]
    flat = [call for mb in want for call in mb]
    assert len(got) == len(flat) == len(want) * moe_layers
    for g, w in zip(got, flat):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for r in _world()[1:]:
        assert r["jobs"][i]["routes"] == got        # gathered on every rank


@pytest.mark.parametrize("i", range(len(JOBS)), ids=NAMES)
def test_sharded_moe_steps_match_the_references_sharded_step(i):
    want = _reference()[i]
    ranks = [r["jobs"][i] for r in _world()]
    for r in ranks:
        assert r["steps"] == ranks[0]["steps"]
    for got, ref in zip(ranks[0]["steps"], want["steps"]):
        for key in ("loss", "grad_norm"):
            assert _rel(got[key], ref[key]) <= STEP_TOL, (key, got, ref)
    for name, ref in want["leaves"].items():
        ref = np.asarray(ref, np.float32)
        diff = np.linalg.norm(ranks[0]["leaves"][name] - ref)
        assert diff <= LEAF_TOL * np.linalg.norm(ref), name


@pytest.mark.parametrize("i", range(len(JOBS)), ids=NAMES)
def test_each_rank_holds_only_its_shards(i):
    for r in _world():
        b = r["jobs"][i]["bytes"]
        assert b["params"] == b["m"] == b["v"] == b["shards"]
        assert b["accumulators"] == b["accumulators_want"]
        assert b["shards"] < b["whole"] / 2


def test_the_a2a_ranks_hold_their_experts_alone():
    """deepseek's experts (4 over a model axis of 2) run 2 a rank;
    maverick's scatter runs all 4 on every rank."""
    for r in _world():
        assert r["jobs"][0]["experts_held"] == [2]
        assert r["jobs"][1]["experts_held"] == [4]
        assert r["jobs"][0]["mesh_stats"]["model"]["calls"] > 0


def _one_device_steps(job) -> list:
    cfg, tree = mesh_smoke.train_mesh_cfg(job)
    params = model.trainable(convert.lm_params_from_jax(tree, cfg, "cpu"))
    data = SyntheticLM(cfg, job["batch"], job["seq"], seed=job["data_seed"])
    step = make_train_step(cfg, lambda s: job["lr"], job["microbatches"])
    opt = adamw.init(params)
    out = []
    for s in range(job["num_steps"]):
        b = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in data.batch_at(s).items()}
        params, opt, m = step(params, opt, b)
        out.append(float(m["loss"]))
    return out


def test_the_scatter_is_the_one_device_dispatch_and_the_a2a_is_not():
    """maverick on the data-only mesh takes the global dispatch, which is
    the one-device step's; deepseek's a2a keeps the reference's
    block-local capacity, which drops other pairs than one device's."""
    mav = [s["loss"] for s in _world()[0]["jobs"][1]["steps"]]
    np.testing.assert_allclose(mav, _one_device_steps(JOBS[1]), rtol=1e-5)
    ds = [s["loss"] for s in _world()[0]["jobs"][0]["steps"]]
    assert abs(ds[0] - _one_device_steps(JOBS[0])[0]) > 1e-5
