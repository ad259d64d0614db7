"""Port ≡ reference for the serving tier (``tests/test_serve_tier.py``,
test for test): token-bucket admission, metrics, the IMM bound's inverse,
pool clone/shrink, replica routing with its epoch guard, autoscaling and
the end-to-end tier.  Pools, answers and decisions are compared with the
reference's on the same graph bit for bit; triggers are deterministic
(fake clocks, ``refresh_now``, ``deadline=0.0``, explicit
``autoscaler.step()``), and nothing asserts a time that depends on the
clock."""
import concurrent.futures
import itertools
import math
import threading

import numpy as np
import pytest
import torch

from repro.core import imm as jimm
from repro.graph import generators as jgen
from repro.serve.influence import PoolConfig as JPoolConfig
from repro.serve.influence import QueryEngine as JEngine
from repro.serve.influence import SketchStore as JStore
from repro.serve.tier import AutoScaler as JAutoScaler
from repro.serve.tier import Histogram as JHistogram
from repro.serve.tier import ReplicaGroup as JGroup
from repro_torch import convert
from repro_torch.core import imm
from repro_torch.graph import generators as tgen
from repro_torch.serve.influence import PoolConfig, QueryEngine, SketchStore
from repro_torch.serve.tier import (AdmissionController, AutoScaler,
                                    EpochMixError, Histogram, MetricSet,
                                    ReplicaGroup, ServingTier, ShedError)
from repro_torch.serve.tier.metrics import escape_label

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return (jgen.powerlaw_cluster(180, 5.0, prob=0.25, seed=23),
            tgen.powerlaw_cluster(180, 5.0, prob=0.25, seed=23,
                                  device="cpu"))


def make_store(graph, batches=4, max_batches=16):
    s = SketchStore(graph, PoolConfig(num_colors=64, max_batches=max_batches,
                                      master_seed=11))
    s.ensure(batches)
    return s


def make_jstore(graph, batches=4, max_batches=16):
    s = JStore(graph, JPoolConfig(num_colors=64, max_batches=max_batches,
                                  master_seed=11))
    s.ensure(batches)
    return s


def _stack(store) -> np.ndarray:
    return convert.masks_to_numpy(store.visited_stack())


def _assert_same_pool(tstore, jstore):
    assert tstore.version == jstore.version
    assert [b.batch_index for b in tstore.batches] == \
        [b.batch_index for b in jstore.batches]
    np.testing.assert_array_equal(_stack(tstore),
                                  np.asarray(jstore.visited_stack()))


# ------------------------------------------------------------- admission
class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_quota_burst_then_shed_with_honest_retry_after():
    clock = FakeClock()
    adm = AdmissionController(rate=2.0, burst=3, clock=clock)
    for _ in range(3):
        adm.admit("t")
    with pytest.raises(ShedError) as ei:
        adm.admit("t")
    assert ei.value.retry_after == pytest.approx(0.5)
    assert ei.value.tenant == "t"
    clock.t += ei.value.retry_after
    adm.admit("t")


def test_quota_refill_caps_at_burst():
    clock = FakeClock()
    adm = AdmissionController(rate=10.0, burst=2, clock=clock)
    adm.admit("t"), adm.admit("t")
    clock.t += 3600
    adm.admit("t"), adm.admit("t")
    with pytest.raises(ShedError):
        adm.admit("t")


def test_quota_per_tenant_isolation_and_unmetered():
    clock = FakeClock()
    adm = AdmissionController(rate=1.0, burst=1, clock=clock)
    adm.set_quota("vip", rate=None)
    adm.admit("a")
    with pytest.raises(ShedError):
        adm.admit("a")
    adm.admit("b")
    for _ in range(100):
        adm.admit("vip")
    assert adm.quota("vip") is None
    assert adm.quota("a") == (1.0, 1.0)


def test_quota_cost_over_burst_sheds_non_retriably():
    clock = FakeClock()
    adm = AdmissionController(rate=2.0, burst=3, clock=clock)
    with pytest.raises(ShedError) as ei:
        adm.admit("t", cost=5.0)
    assert math.isinf(ei.value.retry_after)
    assert "do not retry" in str(ei.value)
    for _ in range(3):
        adm.admit("t")


def test_quota_dotted_tenant_ids_stay_in_totals():
    clock, m = FakeClock(), MetricSet()
    adm = AdmissionController(rate=1.0, burst=1, clock=clock, metrics=m)
    adm.admit("org.acme")
    with pytest.raises(ShedError):
        adm.admit("org.acme")
    assert m.snapshot()["tenant"]["org%2Eacme"] == {"admitted": 1, "shed": 1}
    assert escape_label("org.acme") != escape_label("org%2Eacme")


def test_quota_counts_into_metrics():
    clock, m = FakeClock(), MetricSet()
    adm = AdmissionController(rate=1.0, burst=1, clock=clock, metrics=m)
    adm.admit("t")
    with pytest.raises(ShedError):
        adm.admit("t")
    assert m.snapshot()["tenant"]["t"] == {"admitted": 1, "shed": 1}
    assert m.to_json() == '{"tenant": {"t": {"admitted": 1, "shed": 1}}}'


# --------------------------------------------------------------- metrics
def test_histogram_quantiles_from_bucket_cdf():
    values = [0.0005] * 50 + [0.05] * 49 + [5.0]
    h = Histogram(bounds=[0.001, 0.01, 0.1, 1.0])
    jh = JHistogram(bounds=[0.001, 0.01, 0.1, 1.0])
    for v in values:
        h.record(v)
        jh.record(v)
    assert h.quantile(0.50) == pytest.approx(0.001)
    assert h.quantile(0.99) == pytest.approx(0.1)
    assert h.quantile(0.999) == pytest.approx(5.0)
    snap = h.snapshot()
    assert snap == jh.snapshot()
    assert snap["count"] == 100 and snap["max"] == pytest.approx(5.0)
    assert set(snap) == {"count", "mean", "max", "p50", "p99", "p999"}
    default, jdefault = Histogram(), JHistogram()
    for v in (3e-5, 0.002, 0.0031, 0.9, 700.0):
        default.record(v)
        jdefault.record(v)
    assert default.snapshot() == jdefault.snapshot()


def test_histogram_empty_and_threaded_counter():
    assert Histogram().quantile(0.99) == 0.0
    m = MetricSet()
    c = m.counter("x.y")

    def hammer():
        for _ in range(1000):
            c.add()

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert m.snapshot()["x"]["y"] == 8000
    assert m.counter("x.y") is c


# ------------------------------------------------------- imm bound inverse
def test_eps_bound_inverts_estimate_theta():
    n, k, eps = 2000, 8, 0.3
    lam = imm._lam_star_coeff(n, k, imm._adjusted_ell(n, 1.0)) / eps ** 2
    theta = int(np.ceil(lam / 1.0))
    got = imm.eps_bound_for_theta(n, k, theta)
    assert got == pytest.approx(eps, rel=0.02)
    assert got == jimm.eps_bound_for_theta(n, k, theta)
    assert imm.eps_bound_for_theta(n, k, 4 * theta) == pytest.approx(
        eps / 2, rel=0.02)
    assert imm.eps_bound_for_theta(n, k, theta, opt_lb=4.0) < got


# ----------------------------------------------------------- clone/shrink
def test_store_clone_shares_pool_bit_identically(graphs):
    gj, gt = graphs
    store, jstore = make_store(gt), make_jstore(gj)
    twin = store.clone()
    np.testing.assert_array_equal(_stack(store), _stack(twin))
    assert twin.version == store.version
    assert store.refresh(0.5) == twin.refresh(0.5) == jstore.refresh(0.5)
    np.testing.assert_array_equal(_stack(store), _stack(twin))
    _assert_same_pool(twin, jstore)


def test_store_shrink_keeps_slot_prefix(graphs):
    gj, gt = graphs
    store, jstore = make_store(gt), make_jstore(gj)
    before = _stack(store)
    assert store.shrink(2) == jstore.shrink(2) == [2, 3]
    assert len(store.batches) == 2
    np.testing.assert_array_equal(_stack(store), before[:2])
    store.ensure(4)
    jstore.ensure(4)
    np.testing.assert_array_equal(_stack(store)[:2], before[:2])
    _assert_same_pool(store, jstore)


def test_store_shrink_then_grow_never_reissues_a_version(graphs):
    _, gt = graphs
    store = make_store(gt)
    seen = {store.version}
    old_tail_index = store.batches[-1].batch_index
    store.shrink(2)
    assert store.version not in seen
    seen.add(store.version)
    store.ensure(4)
    assert store.version not in seen
    assert store.batches[-1].batch_index != old_tail_index


# ----------------------------------------------------------------- router
def _fake_future(value, version):
    f = concurrent.futures.Future()
    f.pool_version = version
    f.set_result(value)
    return f


def test_gather_refuses_mixed_epochs():
    ok = ReplicaGroup.gather([_fake_future(1.0, (0, 4)),
                              _fake_future(2.0, (0, 4))])
    assert ok == [1.0, 2.0]
    with pytest.raises(EpochMixError) as ei:
        ReplicaGroup.gather([_fake_future(1.0, (0, 4)),
                             _fake_future(2.0, (1, 4))])
    assert ei.value.versions == ((0, 4), (1, 4))


class _Recording(concurrent.futures.Future):
    """A resolved future that records the timeout each wait was given."""

    def __init__(self, log, value):
        super().__init__()
        self.log = log
        self.pool_version = (0, 4)
        self.set_result(value)

    def result(self, timeout=None):
        self.log.append(timeout)
        return super().result(timeout)


def test_gather_timeout_is_one_overall_deadline():
    """gather(timeout=T) gives the futures one shared deadline: every wait
    gets at most T, each no more than the one before, and a future that
    never resolves times out."""
    log = []
    futs = [_Recording(log, i) for i in range(4)]
    assert ReplicaGroup.gather(futs, timeout=30.0) == [0, 1, 2, 3]
    assert len(log) == 4 and all(0 < t <= 30.0 for t in log)
    assert log == sorted(log, reverse=True)
    assert ReplicaGroup.gather(futs) == [0, 1, 2, 3] and log[-1] is None
    pending = concurrent.futures.Future()
    pending.pool_version = (0, 4)
    with pytest.raises(concurrent.futures.TimeoutError):
        ReplicaGroup.gather([futs[0], pending], timeout=0.0)


def test_replica_group_policies_and_refresh_convergence(graphs):
    gj, gt = graphs
    store, jstore = make_store(gt), make_jstore(gj)
    with ReplicaGroup.build(store, 3, policy="round_robin",
                            default_deadline=0.02) as group:
        assert [group.pick().index for _ in range(4)] == [0, 1, 2, 0]
        assert group.consistent()
        assert group.refresh(0.5) == jstore.refresh(0.5)
        assert group.consistent()
        for r in group.replicas:
            _assert_same_pool(r.store, jstore)
        fut = group.submit_sigma([1, 5, 9])
        want = QueryEngine(group.replicas[0].store).sigma([[1, 5, 9]])[0]
        assert group.gather([fut]) == [want]
        assert want == JEngine(jstore).sigma([[1, 5, 9]])[0]
    with pytest.raises(ValueError):
        ReplicaGroup.build(store, 1, policy="fastest")


def test_replica_group_scale_to_keeps_replicas_identical(graphs):
    gj, gt = graphs
    with ReplicaGroup.build(make_store(gt), 2,
                            default_deadline=0.02) as group, \
            JGroup.build(make_jstore(gj), 1, default_deadline=0.02) as jg:
        for size in (7, 3):
            group.scale_to(size)
            jg.scale_to(size)
            assert group.num_batches == size and group.consistent()
            for r in group.replicas:
                _assert_same_pool(r.store, jg.replicas[0].store)


def test_concurrent_refresh_and_scale_sweeps_keep_replicas_identical(graphs):
    """The refresh and scale sweeps race from two threads; the group
    mutation lock keeps every replica on one mutation sequence."""
    _, gt = graphs
    store = make_store(gt, batches=3, max_batches=32)
    with ReplicaGroup.build(store, 2, default_deadline=0.0) as group:
        start = threading.Barrier(2)
        sizes = itertools.cycle([4, 2, 5])
        errors = []

        def run(fn):
            try:
                start.wait(10)
                for _ in range(5):
                    fn()
            except Exception as e:            # pragma: no cover
                errors.append(e)

        threads = [
            threading.Thread(target=run, args=(lambda: group.refresh(0.5),)),
            threading.Thread(target=run,
                             args=(lambda: group.scale_to(next(sizes)),))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors
        assert group.consistent()
        r0, r1 = group.replicas
        assert r0.store.next_batch_index == r1.store.next_batch_index
        assert [b.batch_index for b in r0.store.batches] == \
            [b.batch_index for b in r1.store.batches]
        np.testing.assert_array_equal(_stack(r0.store), _stack(r1.store))


# -------------------------------------------------------------- autoscaler
def _decisions_match(d, jd):
    assert (d.action, d.batches_before, d.batches_after, d.theta) == \
        (jd.action, jd.batches_before, jd.batches_after, jd.theta)
    assert d.eps_bound == jd.eps_bound


def test_autoscaler_grows_to_meet_eps_then_holds(graphs):
    gj, gt = graphs
    with ReplicaGroup.build(make_store(gt, batches=2), 2,
                            default_deadline=0.0) as group, \
            JGroup.build(make_jstore(gj, batches=2), 1,
                         default_deadline=0.0) as jg:
        scaler = AutoScaler(group, k=4, target_eps=0.4)
        jscaler = JAutoScaler(jg, k=4, target_eps=0.4)
        d1, jd1 = scaler.step(), jscaler.step()
        assert d1.action == "grow" and d1.batches_after > d1.batches_before
        _decisions_match(d1, jd1)
        assert scaler.eps_bound() <= 0.4 + 1e-9
        assert group.consistent()
        _assert_same_pool(group.replicas[1].store, jg.replicas[0].store)
        d2, jd2 = scaler.step(), jscaler.step()
        assert d2.action == "hold"
        _decisions_match(d2, jd2)


def test_autoscaler_shrinks_on_slow_p99_with_eps_headroom(graphs):
    _, gt = graphs
    hist = Histogram()
    for _ in range(200):
        hist.record(1.0)
    with ReplicaGroup.build(make_store(gt, batches=6), 1,
                            default_deadline=0.0) as group:
        scaler = AutoScaler(group, k=4, target_eps=10.0,
                            target_p99_ms=50.0, latency_hist=hist)
        d = scaler.step()
        assert d.action == "shrink"
        assert d.batches_after == d.batches_before - 1
        assert group.num_batches == 5
        assert d.p99_ms == pytest.approx(hist.quantile(0.99) * 1e3)


def test_autoscaler_respects_max_batches(graphs):
    _, gt = graphs
    with ReplicaGroup.build(make_store(gt, batches=2), 1,
                            default_deadline=0.0) as group:
        scaler = AutoScaler(group, k=4, target_eps=0.01, max_batches=3)
        d = scaler.step()
        assert d.batches_after == 3
        d2 = scaler.step()
        assert d2.action == "hold" and "max_batches" in d2.reason
        assert [x.action for x in scaler.decisions] == ["grow", "hold"]


# ----------------------------------------------------------- end-to-end
def test_tier_end_to_end_sheds_and_serves_bit_identically(graphs):
    """2 replicas: an over-quota tenant sheds with retry-after while the
    other's answers equal a direct engine on a clone and the reference's
    engine on the same pool."""
    gj, gt = graphs
    store = make_store(gt)
    reference = QueryEngine(store.clone())
    jreference = JEngine(make_jstore(gj))
    with ServingTier.build(store, replicas=2, quota_qps=None,
                           default_deadline=0.01) as tier:
        tier.admission._clock = FakeClock()     # no refill during the test
        tier.set_quota("starved", rate=0.1, burst=2)
        queries = [[i, i + 3, i + 11] for i in range(8)]
        futs, sheds = [], []
        for q in queries:
            futs.append((q, tier.submit_sigma("paid", q)))
        for q in queries:
            try:
                futs.append((q, tier.submit_sigma("starved", q)))
            except ShedError as e:
                sheds.append(e)
        assert len(sheds) == 6 and len(futs) == 10
        assert all(s.retry_after > 0 and s.tenant == "starved"
                   for s in sheds)
        values = tier.gather([f for _, f in futs])
        for (q, _), val in zip(futs, values):
            assert val == reference.sigma([q])[0] == \
                jreference.sigma([q])[0]
        snap = tier.snapshot()
        assert snap["totals"]["shed"] == len(sheds)
        assert snap["totals"]["admitted"] == len(futs)
        assert 0 < snap["totals"]["shed_rate"] < 1
        assert snap["latency"]["all"]["count"] >= len(futs)
        assert snap["consistent"]
        assert sum(r["dispatches"] for r in snap["replicas"]) >= 1
        assert '"consistent": true' in tier.to_json()


def test_tier_mid_stream_refresh_never_mixes_epochs(graphs):
    """A refresh of one replica between two gathered queries surfaces as
    EpochMixError, never as a mixed answer; the finished sweep
    re-converges the group."""
    _, gt = graphs
    store = make_store(gt)
    with ServingTier.build(store, replicas=2, quota_qps=None,
                           policy="round_robin",
                           default_deadline=0.01) as tier:
        before = tier.submit_sigma("a", [1, 2, 3])        # replica 0
        before.result(timeout=60)
        tier.group.replicas[0].frontend.refresh_now(0.5)
        assert not tier.group.consistent()
        after = tier.submit_sigma("a", [4, 5, 6])         # replica 1
        after.result(timeout=60)
        assert before.pool_version == after.pool_version
        later = tier.submit_sigma("a", [4, 5, 6], deadline=0.0)  # replica 0
        later.result(timeout=60)
        with pytest.raises(EpochMixError):
            tier.gather([before, later])
        for r in tier.group.replicas[1:]:
            r.frontend.refresh_now(0.5)
        assert tier.group.consistent()
        f1 = tier.submit_sigma("a", [1, 2, 3])
        f2 = tier.submit_sigma("a", [4, 5, 6])
        assert len(tier.gather([f1, f2])) == 2


def test_tier_autoscale_step_keeps_group_consistent(graphs):
    _, gt = graphs
    store = make_store(gt, batches=2)
    with ServingTier.build(store, replicas=2, quota_qps=None,
                           autoscale={"k": 4, "target_eps": 0.45},
                           default_deadline=0.0) as tier:
        d = tier.autoscaler.step()
        assert d.action == "grow" and tier.group.consistent()
        a, b = (_stack(r.store) for r in tier.group.replicas)
        np.testing.assert_array_equal(a, b)
        assert tier.snapshot()["autoscale_last"]["action"] == "grow"
