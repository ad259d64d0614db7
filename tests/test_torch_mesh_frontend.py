"""Port ≡ reference for the serving front end on a mesh: one 2×2 gloo
world of 4 CPU ranks (`torch_mesh_workers.mesh_frontend_world`, spawned
once for the module, every collective under a 10 s timeout).  Rank 0
runs `AsyncFrontEnd` over a `MeshLeader` and the other ranks `follow`,
through the GPU smoke's own session (`launch.mesh_smoke._front_end`), as
``tests/serve_distributed_check.py:454-501`` drives the reference's front
end over a `DistributedQueryEngine`:

* a lone request flushes at its deadline;
* 24 threaded clients, a top-16 and a marginal query each get the answer
  the engine gives directly after ``STOP`` (in lockstep on every rank, on
  the pool of the answer's version), which also equals the one-device
  `QueryEngine`'s and live `repro`'s on the same pool;
* ``max_queue_wait`` ≤ deadline + 0.25 s; a refresh bumps the epoch on
  every rank; the version holds after ``close()``;
* an oversized submit fails only its caller; a front end idle for longer
  than the collective timeout survives on ``NOOP``s; the followers make
  the leader's calls in its order and leave `follow` on close;
* `Mesh.broadcast` over every axis sends rank 0's tensor, one call per
  axis; the mesh samplers' ``sample_stacked`` equals the reference's.

The launcher's ``--smoke --async --mesh 2x2`` runs too.  Tolerance:
exact (integer counts scaled by n/θ; seeds and masks are integers;
marginal gains by the sha256 of their float64 bytes)."""
import functools
import tempfile

import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.serve import influence as jserve
from repro_torch.launch import accel, mesh_smoke
from repro_torch.launch import serve_influence as tlaunch
from repro_torch.serve import influence as tserve

import torch_mesh_workers as workers

torch.set_num_threads(1)
_TMP = tempfile.TemporaryDirectory(prefix="mesh_frontend_")


@functools.lru_cache(maxsize=None)
def _world() -> list:
    return accel.spawn(workers.mesh_frontend_world, 4, args=(_TMP.name,),
                       device="cpu", timeout_s=180)


def _lead() -> dict:
    return _world()[0]["f"]


@functools.lru_cache(maxsize=None)
def _reference_graph():
    g = workers.FRONT_GRAPH
    return jcsr.dedupe(jgen.powerlaw_cluster(g["n"], g["degree"],
                                             prob=g["prob"], seed=g["seed"]))


@functools.lru_cache(maxsize=None)
def _one_device() -> dict:
    """Per pool version the session reached: the direct answers of live
    `repro`'s dense pool and of the port's one-device `QueryEngine`, each
    refreshed as the front end refreshed the sharded pool."""
    spec = dict(num_colors=workers.COLORS, master_seed=workers.FRONT_SEED)
    sj = jserve.SketchStore(_reference_graph(), jserve.PoolConfig(
        max_batches=8, **spec))
    st = tserve.SketchStore(workers.front_graph(), tserve.PoolConfig(
        max_batches=8, **spec))
    sj.ensure(workers.FRONT_BATCHES)
    st.ensure(workers.FRONT_BATCHES)
    queries = mesh_smoke._fe_queries(workers.FRONT_GRAPH["n"])
    out = {}
    while True:
        assert sj.version == st.version
        out[st.version] = (
            mesh_smoke._fe_direct(jserve.QueryEngine(sj), queries),
            mesh_smoke._fe_direct(tserve.QueryEngine(st), queries))
        if st.version == _lead()["version"]:
            return out
        assert st.refresh(0.25) == sj.refresh(0.25)


def _served():
    """(kind, index, value, version) of every answer rank 0 served."""
    a = _lead()["answers"]
    yield ("lone", None) + a["lone"]
    for i, (value, version) in enumerate(a["clients"]):
        yield ("clients", i, value, version)
    yield ("top_k", None) + a["top_k"]
    yield ("marginal", None) + a["marginal"]


def _pick(answers, kind, index):
    return answers[kind] if index is None else answers[kind][index]


def test_broadcast_over_every_axis_sends_rank_0s_tensor():
    for rank_out in _world():
        sent, stats = rank_out["broadcast"]
        assert sent == [5, 5, 5]
        assert stats == {"data": {"calls": 1, "bytes": 12},
                         "model": {"calls": 1, "bytes": 12}}


def test_lone_request_flushes_at_its_deadline():
    lead = _lead()
    assert lead["lone_deadline_flushes"] >= 1
    value, version = lead["answers"]["lone"]
    for rank_out in _world():
        assert rank_out["f"]["direct"][version]["lone"] == value


def test_every_answer_equals_the_engine_directly_on_every_rank():
    for kind, i, value, version in _served():
        for rank_out in _world():
            direct = rank_out["f"]["direct"][version]
            assert _pick(direct, kind, i) == value, \
                (kind, i, rank_out["rank"])


def test_every_answer_equals_the_one_device_engine_and_the_reference():
    reference = _one_device()
    for kind, i, value, version in _served():
        ref, port = reference[version]
        assert _pick(port, kind, i) == value, (kind, i)
        assert _pick(ref, kind, i) == value, (kind, i)
    lead = _lead()
    # The final pool restored onto one device, inside the world.
    assert lead["one_device"]["answers"] == lead["direct"][lead["version"]]


def test_no_request_waits_past_its_deadline():
    assert _lead()["stats"]["max_queue_wait"] \
        <= mesh_smoke.FE_DEADLINE_S + 0.25


def test_refresh_bumps_the_epoch_on_every_rank_and_holds_after_close():
    lead = _lead()
    assert lead["stats"]["refreshes"] >= 1
    assert lead["messages"]["refresh"] == lead["stats"]["refreshes"]
    assert lead["version_later"] == lead["version_closed"]
    versions = {r["f"]["version"] for r in _world()}
    assert versions == {lead["version"]}
    graph_epoch, epoch, count = lead["version"]
    assert epoch == lead["stats"]["refreshes"] >= 1
    assert count == workers.FRONT_BATCHES and graph_epoch == 0


def test_followers_make_the_leaders_calls_and_leave_on_close():
    lead = _lead()
    ops = [op for op, _ in lead["dispatches"]]
    assert lead["messages"]["stop"] == 1
    assert {"top_k", "sigma", "marginal", "refresh"} <= set(ops)
    for rank_out in _world()[1:]:
        follow = rank_out["f"]
        assert [op for op, _ in follow["dispatches"]] == ops
        assert follow["messages"] == lead["messages"]


def test_oversized_submit_fails_only_its_caller():
    idle = _world()[0]["idle"]
    assert idle["oversized"] is not None and "max_seeds" in idle["oversized"]
    # Validation broadcasts nothing: the followers saw the same messages,
    # one σ dispatch (the query after the gap) and the STOP.
    assert idle["messages"]["sigma"] == 1 and idle["messages"]["stop"] == 1
    for rank_out in _world()[1:]:
        assert rank_out["idle_follow"] == idle["messages"]


def test_idle_gap_longer_than_the_group_timeout_survives():
    idle = _world()[0]["idle"]
    assert idle["gap_s"] > workers.FRONT_TIMEOUT_S
    assert idle["messages"]["noop"] >= 1
    assert idle["version"] == _lead()["version"]
    for rank_out in _world():
        assert rank_out["f"]["direct"][idle["version"]]["lone"] \
            == idle["value"]


@pytest.mark.parametrize("backend", ["graph_parallel", "data_parallel"])
def test_mesh_sample_stacked_equals_the_reference(backend):
    """`_BlockSampler.sample_stacked`: the block's global ``(B, V, W)``
    masks on every rank, row padding trimmed; ``[]`` gives ``(0, V, W)``."""
    dense = jsampling.make_sampler(_reference_graph(), jsampling.SamplerSpec(
        num_colors=workers.COLORS, master_seed=workers.FRONT_SEED))
    n = workers.FRONT_GRAPH["n"]
    for rank_out in _world():
        for idx, got in zip(workers.STACKED, rank_out["stacked"][backend]):
            if idx:
                np.testing.assert_array_equal(
                    got, np.asarray(dense.sample_stacked(idx)))
            else:
                assert got.shape == (0, n, 2)


def test_launcher_smoke_async_on_a_mesh(capfd):
    out = tlaunch.main(["--device", "cpu", "--smoke", "--async", "--mesh",
                        "2x2", "--backend", "gloo"])
    assert len(out) == 4 and all(r["passed"] for r in out)
    assert out[0]["async"]["stats"]["deadline_flushes"] >= 1
    assert out[0]["async"]["messages"]["stop"] == 1
    assert all("async" not in r for r in out[1:])
    text = capfd.readouterr().out
    assert "[async]" in text and "[smoke] PASS" in text
    assert text.index("[async]") < text.index("[smoke] PASS")


# ----------------------------------- the leader alone, on a 1×1 mesh here
@functools.lru_cache(maxsize=None)
def _one_rank_engine():
    """A `DistributedQueryEngine` on a 1×1 mesh in this process (no
    process group: every collective returns its input)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.distributed import (DistributedQueryEngine,
                                               ShardedSketchStore)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    store = ShardedSketchStore(workers.front_graph(), tserve.PoolConfig(
        max_batches=8, spec=workers.front_spec("graph_parallel")), mesh)
    store.ensure(workers.FRONT_BATCHES)
    return DistributedQueryEngine(store)


def test_leader_broadcasts_refresh_and_refuses_other_store_calls():
    from repro_torch.serve.distributed import AsyncFrontEnd, MeshLeader
    engine = _one_rank_engine()
    single = tserve.SketchStore(workers.front_graph(), tserve.PoolConfig(
        max_batches=8, num_colors=workers.COLORS,
        master_seed=workers.FRONT_SEED))
    single.ensure(workers.FRONT_BATCHES)
    with MeshLeader(engine, keepalive_s=60.0) as leader:
        with AsyncFrontEnd(tserve.MicroBatcher(leader),
                           default_deadline=0.01) as fe:
            assert fe.refresh_now(0.5) == single.refresh(0.5)
            with pytest.raises(RuntimeError, match="only refresh"):
                fe.mutate_store(lambda store: store.ensure(8))
            got = fe.submit_sigma([1, 2]).result(timeout=30)
        assert leader.stats.messages["refresh"] == 1
    assert got == tserve.QueryEngine(single).sigma([[1, 2]])[0]
    assert engine.store.version == single.version


def test_closed_leader_fails_the_flush_not_the_front_end():
    from repro_torch.serve.distributed import AsyncFrontEnd, MeshLeader
    from repro_torch.serve.influence import FlushError
    engine = _one_rank_engine()
    leader = MeshLeader(engine, keepalive_s=60.0)
    leader.close()
    leader.close()                                  # idempotent
    assert leader.stats.messages["stop"] == 1
    with AsyncFrontEnd(tserve.MicroBatcher(leader),
                       default_deadline=0.01) as fe:
        with pytest.raises(FlushError):
            fe.submit_sigma([1]).result(timeout=30)


@pytest.mark.parametrize("fraction", [0.1, 0.25, 1 / 3])
def test_message_carries_the_refresh_fraction_bit_for_bit(fraction):
    from repro_torch.serve.distributed import mesh_frontend
    engine = _one_rank_engine()
    msg = mesh_frontend._encode(engine, mesh_frontend.REFRESH,
                                fraction=fraction)
    assert msg.shape == (mesh_frontend.message_size(engine),)
    assert msg[2:4].numpy().view(np.float64)[0] == fraction
