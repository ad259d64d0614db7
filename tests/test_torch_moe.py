"""Port ≡ reference for Mixture-of-Experts (``models/mlp.py``).

The port's `mlp.moe_forward` (one-device scatter) is held against the
reference's on the same numpy weights (`models/init.py::numpy_moe`) and
tokens, in float32 on the CPU, at 1e-5: capacity factors 0.25 (tokens
dropped), 1.25 and 64 (none dropped), a router with duplicated columns
(ties, where ``lax.top_k`` keeps the lower expert), decode's shape
(capacity 1) and the aux loss.  The reference's dense-oracle test
(``tests/test_models.py::test_moe_matches_dense_oracle_unbounded_capacity``)
runs again on the port.  The expert-parallel form (`_moe_forward_a2a`,
`Mesh.all_to_all`) runs on gloo worlds of 2 and 4 CPU processes
(`torch_mesh_workers.moe_world`) against the reference's own
``_moe_forward_a2a`` on meshes of forced host devices, in a subprocess
(``scripts/make_torch_golden.py::moe_reference_subprocess``)."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import mlp as jmlp
from repro_torch.configs import registry
from repro_torch.launch import accel
from repro_torch.models import init, mlp

import torch_mesh_workers as workers

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import make_torch_golden  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["deepseek-v3-671b", "llama4-maverick-400b-a17b"]
WORLD_JOBS = {
    2: [dict(arch="deepseek-v3-671b", smoke=True, seed=3, batch=2, seq=16,
             shape=[1, 2], full=True)],
    4: [dict(arch="deepseek-v3-671b", smoke=True, seed=4, batch=2, seq=16,
             shape=[2, 2], full=True),
        dict(arch="llama4-maverick-400b-a17b", smoke=True, seed=5, batch=4,
             seq=8, shape=[2, 2], full=True,
             overrides={"capacity_factor": 0.5})],
}
CASES = [(w, i) for w in sorted(WORLD_JOBS) for i in range(len(WORLD_JOBS[w]))]


def _cfgs(arch="deepseek-v3-671b", **kw):
    """(reference, port) smoke configs in float32 with ``kw`` replaced."""
    kw = dict(kw, dtype="float32")
    return (dataclasses.replace(jregistry.smoke(arch), **kw),
            dataclasses.replace(registry.smoke(arch), **kw))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _both(jc, tc, tree, x):
    want, waux = jmlp.moe_forward(_jax(tree), jnp.asarray(x), jc)
    got, gaux = mlp.moe_forward(_torch(tree), torch.from_numpy(x), tc)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(float(gaux), float(waux))
    return got


def _kept(tc, tree, x) -> int:
    """Pairs the port's dispatch keeps."""
    xt = torch.from_numpy(x).reshape(-1, tc.d_model)
    gate, idx, _ = mlp._route(torch.from_numpy(tree["router"]), xt, tc.top_k)
    cap = mlp.capacity(xt.shape[0], tc)
    return int(mlp._local_dispatch(xt, gate, idx, tc.num_experts, cap)[3]
               .sum())


# ------------------------------------------------------------ one device
@pytest.mark.parametrize("cf", [0.25, 1.25, 64.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_scatter_moe_equals_the_reference(arch, cf):
    jc, tc = _cfgs(arch, capacity_factor=cf)
    tree = init.numpy_moe(tc, 1)
    x = init.numpy_moe_input(tc, 1, 2, 16)
    got = _both(jc, tc, tree, x)
    assert torch.isfinite(got).all()
    pairs = 2 * 16 * tc.top_k
    kept = _kept(tc, tree, x)
    if cf == 64.0:
        assert kept == pairs
    if cf == 0.25:
        assert kept < pairs          # the reference's drop path runs


def test_router_ties_keep_the_lower_expert():
    """Two pairs of equal router columns: every token's probabilities tie
    in pairs, and the port picks the reference's experts and output."""
    jc, tc = _cfgs(capacity_factor=1.25)
    tree = init.numpy_moe(tc, 2)
    tree["router"][:, 1] = tree["router"][:, 0]
    tree["router"][:, 3] = tree["router"][:, 2]
    x = init.numpy_moe_input(tc, 2, 2, 16)
    xt = x.reshape(-1, tc.d_model)
    _, want_idx = jax.lax.top_k(
        jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(tree["router"]), -1),
        tc.top_k)
    _, idx, _ = mlp._route(torch.from_numpy(tree["router"]),
                           torch.from_numpy(xt), tc.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert (idx[:, 0] % 2 == 0).all()   # a tie's lower expert comes first
    _both(jc, tc, tree, x)


def test_decode_shape_has_capacity_one():
    """Batch 4 of one token over 16 experts, top-2: capacity 1, so tokens
    are dropped as the reference drops them; and deepseek-v3's own
    capacities at batch 4 (decode) and 4 × 2,048 (prefill)."""
    jc, tc = _cfgs(num_experts=16)
    assert mlp.capacity(4, tc) == 1
    tree = init.numpy_moe(tc, 6)
    x = init.numpy_moe_input(tc, 6, 4, 1)
    _both(jc, tc, tree, x)
    assert _kept(tc, tree, x) < 4 * tc.top_k
    full = registry.get("deepseek-v3-671b")
    assert (mlp.capacity(4, full), mlp.capacity(8192, full)) == (1, 320)


def test_moe_matches_dense_oracle_unbounded_capacity():
    """The reference's dense-oracle test on the port: with capacity ≥ all
    tokens, MoE == the explicit per-token expert mix."""
    cfg = dataclasses.replace(registry.smoke("deepseek-v3-671b"),
                              capacity_factor=64.0, num_shared_experts=0)
    p = mlp.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    out, aux = mlp.moe_forward(p, x, cfg)

    xt = x.numpy().reshape(-1, cfg.d_model)
    w = {k: v.detach().numpy() for k, v in p.items()}
    logits = xt @ w["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, -1)[:, : cfg.top_k]
    expected = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        gates = probs[t, order[t]]
        gates = gates / gates.sum()
        for j, e in enumerate(order[t]):
            h = xt[t] @ w["experts_w1"][e]
            h = h / (1 + np.exp(-h)) * (xt[t] @ w["experts_w3"][e])
            expected[t] += gates[j] * (h @ w["experts_w2"][e])
    np.testing.assert_allclose(out.numpy().reshape(-1, cfg.d_model),
                               expected, atol=1e-3, rtol=1e-2)
    assert float(aux) > 0


def test_init_moe_layout_and_dtypes():
    """The reference's ``init_moe`` shapes; a bf16 model keeps its router
    in float32."""
    cfg = dataclasses.replace(registry.smoke("deepseek-v3-671b"),
                              dtype="bfloat16")
    p = mlp.init_moe(torch.Generator().manual_seed(0), cfg)
    d, e, fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    assert p["router"].shape == (d, e)
    assert p["router"].dtype == torch.float32
    assert p["experts_w1"].shape == p["experts_w3"].shape == (e, d, fe)
    assert p["experts_w2"].shape == (e, fe, d)
    assert p["experts_w1"].dtype == torch.bfloat16
    f = mlp.shared_d_ff(cfg)
    assert f == fe * cfg.num_shared_experts
    assert p["shared"]["w1"].shape == (d, f)
    want = jax.eval_shape(lambda: jmlp.init_moe(
        jax.random.key(0), jregistry.smoke("deepseek-v3-671b")))
    got = init.numpy_moe(registry.smoke("deepseek-v3-671b"), 0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape


def test_numpy_moe_draws_each_expert_alone():
    """A rank drawing only its experts gets the whole layer's rows."""
    _, tc = _cfgs()
    whole = init.numpy_moe(tc, 9)
    part = init.numpy_moe(tc, 9, experts=[2, 3])
    for k in ("experts_w1", "experts_w2", "experts_w3"):
        np.testing.assert_array_equal(part[k], whole[k][2:4])
    np.testing.assert_array_equal(part["router"], whole["router"])


# ------------------------------------------------------ expert parallel
@functools.lru_cache(maxsize=None)
def _world(world: int) -> list:
    return accel.spawn(workers.moe_world, world, args=(WORLD_JOBS[world],),
                       device="cpu", timeout_s=300)


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    jobs = [j for w in sorted(WORLD_JOBS) for j in WORLD_JOBS[w]]
    res = make_torch_golden.moe_reference_subprocess(jobs)
    return {(j["seed"], tuple(j["shape"])): r for j, r in zip(jobs, res)}


@pytest.mark.parametrize("world", sorted(WORLD_JOBS))
def test_all_to_all_sends_block_j_to_position_j(world):
    for r in _world(world):
        for job in r["jobs"]:
            d_, m_ = job["shape"]
            mine = r["rank"] % m_
            for j, row in enumerate(job["got"]):
                sender = (r["rank"] // m_) * m_ + j
                assert row.tolist() == [sender, mine, 7 * sender + mine]


@pytest.mark.parametrize("world,i", CASES)
def test_a2a_equals_the_reference_a2a(world, i):
    job = WORLD_JOBS[world][i]
    want = _reference()[(job["seed"], tuple(job["shape"]))]
    for r in _world(world):
        got = r["jobs"][i]
        _close(got["out"], want["out"])
        _close(got["aux"], want["aux"])


@pytest.mark.parametrize("world,i", CASES)
def test_moe_forward_on_a_mesh_runs_the_a2a(world, i):
    """The dispatcher with a mesh gives the a2a's output exactly, and two
    all-to-alls and the aux mean go over ``model``."""
    job = WORLD_JOBS[world][i]
    cfg = workers.moe_cfg(job)
    s = job["shape"][1]
    cap = mlp.capacity(job["batch"] * job["seq"] // (s * job["shape"][0]),
                       cfg)
    for r in _world(world):
        got = r["jobs"][i]
        np.testing.assert_array_equal(got["via"], got["out"])
        assert got["via_aux"] == got["aux"]
        assert got["model_stats"] == {
            "calls": 3,
            "bytes": 2 * cfg.num_experts * cap * cfg.d_model * 4 + 4}


def test_a2a_at_unbounded_capacity_equals_the_scatter():
    """At capacity 64 nothing is dropped on any rank, so the a2a equals
    the one-device scatter on the same layer."""
    job = dict(WORLD_JOBS[4][0], overrides={"capacity_factor": 64.0})
    res = accel.spawn(workers.moe_world, 4, args=([job],), device="cpu",
                      timeout_s=300)
    cfg = workers.moe_cfg(job)
    tree = _torch(init.numpy_moe(cfg, job["seed"]))
    x = torch.from_numpy(init.numpy_moe_input(cfg, job["seed"], job["batch"],
                                              job["seq"]))
    want, _ = mlp.moe_forward(tree, x, cfg)
    for r in res:
        _close(r["jobs"][0]["out"], want.numpy())
