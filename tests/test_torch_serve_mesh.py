"""LM serving on a mesh (`serve.engine.prefill` and
`models.decode.decode_step` with ``mesh=``): the prefill's rows over the
data axes, the decode caches in the reference's layout and the
sequence-parallel decode, against one device.

Smoke configs in float32 — llama3.2-3b (GQA), deepseek-v3 (MLA and MoE),
llama4-maverick (GQA and top-1 MoE, dense and MoE layers interleaved),
mamba2 (SSD), zamba2 (SSD and the shared attention block) and musicgen
(codebooks) — prefill 32 tokens and take 4 greedy steps on 2×2 and 1×4
gloo worlds of CPU ranks (`launch.mesh_smoke.rank_serve_mesh`, the card's
rank program) and on one device (`mesh_smoke.serve_one`, the same seeded
weights and prompt): every step's logits of every row agree within 1e-5
and the greedy tokens and every MoE call's expert picks are equal.  The
caches hold 68 (2×2) and 136 (1×4)
positions, so each ``model`` rank holds 34: the writes cross from rank 0
to rank 1 at step 2, and on 1×4 ranks 2 and 3 see no key at all.

deepseek-v3 and maverick run three ways each.  Their decode steps (one
token) take the global scatter over the data axes, one device's capacity.
Their prefill takes the reference's a2a route where it applies
(``moe_impl`` a2a, the prompt dividing over ``model``), whose capacity is
per token block, as the reference's ``shard_map`` has it, not one
device's; so the a2a route is held where no pair drops either way
(deepseek at capacity factor 64, maverick at E / top_k = 4, where the
capacity is the token count), and the dropping capacity of the config on
the scatter route (``moe_impl`` scatter) and at a 15-token prompt (which
does not divide, so the reference's dispatcher takes the scatter too).

llama's and deepseek's jobs also plant the faults the card's check must
see (`mesh_smoke._fault_steps`, `_split_check`; GQA's merge of the
``decode`` kernel's lse, MLA's of its plain softmax): the steps from the
crossing on decoded again with the ``model`` ranks past 0 lost, or with
their log-sum-exp ignored, must leave one device's logits, and the split
check must pass the sound merge and fail both faults.  The card's own
jobs (``chip_smoke.SERVE_MESH_JOBS``) run here too, their cuts applied to
the smoke configs, so that a cut the config does not take fails on the
CPU first.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.launch import accel, mesh_smoke
from repro_torch.models import attention

torch.set_num_threads(1)

TOL = 1e-5
FAMILIES = [("llama3.2-3b", {}, 32), ("mamba2-1.3b", {}, 32),
            ("zamba2-2.7b", {}, 32), ("musicgen-medium", {}, 32),
            ("deepseek-v3-671b", {"moe_impl": "scatter"}, 32),
            ("deepseek-v3-671b", {}, 15),
            ("deepseek-v3-671b", {"capacity_factor": 64.0}, 32),
            ("llama4-maverick-400b-a17b", {"moe_impl": "scatter"}, 32),
            ("llama4-maverick-400b-a17b", {"capacity_factor": 4 / 1}, 32),
            ("llama4-maverick-400b-a17b", {}, 15)]
IDS = [f"{a.split('-')[0]}-{p}" + ("-" + "-".join(map(str, c.values()))
                                   if c else "")
       for a, c, p in FAMILIES]
MESHES = {"2x2": ((2, 2), 68), "1x4": ((1, 4), 136)}


FAULT_FROM = 2                  # the step whose write crosses to rank 1
# The jobs whose faults are planted: llama's (GQA) and deepseek's a2a one
# (MLA).
FAULTS = [0, IDS.index("deepseek-32-64.0")]


def _jobs(shape, max_len):
    return [dict(arch=a, smoke=True, cut=c, seed=0, batch=4, prompt=p,
                 steps=4, max_len=max_len, shape=shape,
                 axes=("data", "model"), timeout_s=120,
                 fault_from=FAULT_FROM if i in FAULTS else None)
            for i, (a, c, p) in enumerate(FAMILIES)]


@pytest.fixture(scope="module", params=list(MESHES))
def served(request):
    shape, max_len = MESHES[request.param]
    jobs = _jobs(shape, max_len)
    ranks = accel.spawn(mesh_smoke.rank_serve_mesh, 4, args=(jobs,),
                        device="cpu", timeout_s=600)
    one = [mesh_smoke.serve_one(job, torch.device("cpu")) for job in jobs]
    return request.param, ranks, one


@pytest.mark.parametrize("case", range(len(FAMILIES)), ids=IDS)
def test_mesh_serving_equals_one_device(served, case):
    name, ranks, one = served
    got, want = ranks[0][case], one[case]
    assert len(got["logits"]) == len(want["logits"]) == 5
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= TOL, (name, IDS[case], step, err)
    # Each rank's greedy tokens are its rows of one device's: data
    # position d of D holds rows [d·4/D, (d+1)·4/D).
    (data, model), _ = MESHES[name]
    for r in ranks:
        n = 4 // data
        lo = r[case]["rank"] // model * n
        for g, w in zip(r[case]["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w[lo:lo + n])
    # Every rank sent the same collectives.
    stats = [r[case]["mesh_stats"] for r in ranks]
    assert all(s == stats[0] for s in stats)
    # Every MoE call picked one device's experts for every token, in one
    # device's token order (rank 0 assembles them).
    assert len(got["routes"]) == len(want["routes"])
    assert bool(got["routes"]) == (FAMILIES[case][0].startswith(
        ("deepseek", "llama4")))
    for (gi, gl), (wi, wl) in zip(got["routes"], want["routes"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gl, wl, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", FAULTS, ids=[IDS[i] for i in FAULTS])
def test_planted_faults_leave_one_device(served, case):
    name, ranks, one = served
    got, want = ranks[0][case], one[case]
    assert set(got["fault_logits"]) == {"lost", "lse"}
    for fault, xs in got["fault_logits"].items():
        assert len(xs) == 4 - FAULT_FROM
        for i, g in enumerate(xs):
            w = want["logits"][1 + FAULT_FROM + i]
            assert float(np.abs(g - w).max()) > 1e3 * TOL, (name, fault, i)
    (data, model), max_len = MESHES[name]
    lc = max_len // model
    assert sorted(got["split"]) == [32 + 4 - lc, max_len - lc]
    for keys, r in got["split"].items():
        assert r["sound"] <= TOL, (name, keys, r)
        assert min(r["lost"], r["lse"]) > 1e-2, (name, keys, r)


def _chip_smoke():
    """The GPU smoke script as a module (its top level imports numpy and
    torch alone; `main` is not run)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def card_jobs():
    """``chip_smoke``'s [serve mesh] jobs, their cuts applied to the smoke
    configs, at the smoke's prompt and steps on 2×2 CPU ranks."""
    jobs = _chip_smoke()._serve_mesh_jobs()
    for job in jobs:
        job.update(smoke=True, prompt=32, steps=4, max_len=68,
                   timeout_s=120, fault_from=(
                       FAULT_FROM if job["fault_from"] is not None
                       else None))
    one = [mesh_smoke.serve_one(job, torch.device("cpu")) for job in jobs]
    for job, o in zip(jobs, one):
        job["feed"] = o["tokens"]
    ranks = accel.spawn(mesh_smoke.rank_serve_mesh, 4, args=(jobs,),
                        device="cpu", timeout_s=600)
    return jobs, ranks, one


def test_card_jobs_run_on_smoke_configs(card_jobs):
    """Every card job's cut is a field of its config, and the job runs:
    the logits of every step, of every row, the rows' fed tokens, and each
    MoE call's picks in one device's token order; the split check of each
    job with planted faults passes the sound merge and fails both faults.
    (The cuts' capacity factors are E / top_k of the full configs, which
    the smoke configs' top_k does not share: the a2a prefill may drop
    other pairs than one device, so the values are not compared here.)"""
    jobs, ranks, one = card_jobs
    assert [j["arch"] for j in jobs] == [
        "llama3.2-3b", "zamba2-2.7b", "deepseek-v3-671b",
        "llama4-maverick-400b-a17b"]
    for i, job in enumerate(jobs):
        cfg = mesh_smoke.serve_cfg(job)
        for key, value in job["cut"].items():
            assert getattr(cfg, key) == value
        got = ranks[0][i]
        assert len(got["logits"]) == len(one[i]["logits"]) == 5
        for g, w in zip(got["logits"], one[i]["logits"]):
            assert g.shape == w.shape and np.isfinite(g).all()
        assert len(got["routes"]) == len(one[i]["routes"]) == (
            5 if cfg.num_experts else 0)
        for (gi, _), (wi, _) in zip(got["routes"], one[i]["routes"]):
            assert gi.shape == wi.shape
        if job["fault_from"] is not None:
            for keys, r in got["split"].items():
                assert r["sound"] <= TOL, (job["arch"], keys, r)
                assert min(r["lost"], r["lse"]) > 1e-2, (job["arch"], r)


def test_merge_ignores_a_rank_without_keys():
    """`attention.merge_partials` on a one-axis stand-in: a rank whose lse
    is -inf adds nothing, whatever its output holds."""
    class Line:
        shape = {"model": 3}

        def all_gather(self, t, axis):
            return torch.cat(parts)

    g = torch.Generator().manual_seed(0)
    s = torch.randn(2, 3, 10, generator=g)          # (B, H, keys)
    v = torch.randn(10, 5, generator=g)
    want = torch.softmax(s, -1) @ v
    outs, lses = [], []
    for lo, hi in ((0, 4), (4, 10)):
        part = s[..., lo:hi]
        outs.append(torch.softmax(part, -1) @ v[lo:hi])
        lses.append(torch.logsumexp(part, -1))
    outs.append(torch.full((2, 3, 5), 1e30))        # the rank with no keys
    lses.append(torch.full((2, 3), float("-inf")))
    parts = [torch.cat([o, l[..., None]], -1) for o, l in zip(outs, lses)]
    got = attention.merge_partials(Line(), outs[0], lses[0])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [-1, 0, 37, 99, 150])
def test_decode_lse_is_the_logsumexp_of_its_scores(dtype, offset):
    g = torch.Generator().manual_seed(offset + 2)
    b, lk, h, kvh, d = 2, 100, 6, 2, 32
    q = torch.randn(b, 1, h, d, generator=g).to(dtype)
    k = torch.randn(b, lk, kvh, d, generator=g).to(dtype)
    v = torch.randn(b, lk, kvh, d, generator=g).to(dtype)
    out, lse = ops.flash_attention(q, k, v, causal=True, kv_offset=offset,
                                   return_lse=True)
    assert out.shape == q.shape and lse.shape == (b, h, 1)
    assert lse.dtype == torch.float32
    vis = min(lk, offset + 1)
    if vis < 1:
        assert torch.all(out == 0) and torch.all(lse == float("-inf"))
        return
    kf = k.float().repeat_interleave(h // kvh, 2)[:, :vis]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, kf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out, ref.flash_attention_ref(
        q, k, v, causal=True, kv_offset=offset), rtol=0, atol=0)
    with pytest.raises(ValueError, match="decode route"):
        ops.flash_attention(q.expand(b, 2, h, d), k, v, return_lse=True)
