"""Port ≡ reference for the one-device serving front end: the reference's
own front-end and batcher tests (``tests/test_serve_distributed.py``'s
in-process ones, and five of ``tests/test_serve_influence.py``'s) run on
the port's `AsyncFrontEnd`, `MicroBatcher`, `ResultCache` and
`QueryEngine` on the CPU, and the launcher's one-device ``--smoke
--async``.

Where a test checks an answer, it also holds it against live `repro` on
the same graph and pool (``powerlaw_cluster(150, 5.0, prob=0.25,
seed=17)``, 64 colours, master_seed 9, 4 batches, as the reference's
fixture builds it; the five serving tests on their own graph,
``powerlaw_cluster(200, 6.0, prob=0.25, seed=13)``).  Tolerance: exact —
σ and gains are integer counts scaled by n/θ in both packages, seeds and
slots are integers."""
import functools
import threading
import time

import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.serve import influence as jserve
from repro_torch.graph import generators as tgen
from repro_torch.launch import serve_influence as tlaunch
from repro_torch.serve.distributed import AsyncFrontEnd
from repro_torch.serve.influence import (FlushError, MicroBatcher, PoolConfig,
                                         QueryEngine, ResultCache, SketchStore)

torch.set_num_threads(1)


def _pair(n=150, degree=5.0, seed=17, master_seed=9, batches=4,
          max_batches=8):
    """(port store, reference store) of one pool on one graph."""
    gj = jgen.powerlaw_cluster(n, degree, prob=0.25, seed=seed)
    gt = tgen.powerlaw_cluster(n, degree, prob=0.25, seed=seed,
                               device="cpu")
    sj = jserve.SketchStore(gj, jserve.PoolConfig(
        num_colors=64, max_batches=max_batches, master_seed=master_seed))
    st = SketchStore(gt, PoolConfig(num_colors=64, max_batches=max_batches,
                                    master_seed=master_seed))
    sj.ensure(batches)
    st.ensure(batches)
    return st, sj


@pytest.fixture(scope="module")
def engines():
    st, sj = _pair()
    return QueryEngine(st), jserve.QueryEngine(sj)


@pytest.fixture(scope="module")
def engine(engines):
    return engines[0]


def _want(ref, seed_sets) -> list:
    """Live `repro`'s σ(S) of ``seed_sets`` (≤ 8 a call)."""
    q = ref.query_slots
    return [float(x) for i in range(0, len(seed_sets), q)
            for x in np.asarray(ref.sigma(seed_sets[i:i + q]))]


def test_reference_pool_equals_the_port_pool(engines):
    engine, ref = engines
    assert engine.store.version == ref.store.version
    np.testing.assert_array_equal(
        engine.store.visited_stack().numpy().view(np.uint32),
        np.asarray(ref.store.visited_stack()))


# ------------------------------------- tests/test_serve_distributed.py
def test_frontend_lone_request_flushes_at_deadline(engines):
    """A lone request must be dispatched by its deadline, not wait for the
    slot batch to fill."""
    engine, ref = engines
    with AsyncFrontEnd(MicroBatcher(engine), default_deadline=0.1,
                       flush_slots=64) as fe:
        fut = fe.submit_sigma([1, 2, 3], deadline=0.1)
        got = fut.result(timeout=30)
    assert got == engine.sigma([[1, 2, 3]])[0] == _want(ref, [[1, 2, 3]])[0]
    assert fe.stats.deadline_flushes >= 1
    assert fe.stats.slot_flushes == 0


def test_frontend_full_slot_flushes_early(engines):
    """flush_slots pending queries dispatch immediately — well before the
    (deliberately huge) deadline."""
    engine, ref = engines
    with AsyncFrontEnd(MicroBatcher(engine), default_deadline=60.0,
                       flush_slots=4) as fe:
        t0 = time.monotonic()
        futs = [fe.submit_sigma([i]) for i in range(4)]
        got = [f.result(timeout=30) for f in futs]
        assert time.monotonic() - t0 < 30.0
    assert fe.stats.slot_flushes >= 1
    assert got == _want(ref, [[i] for i in range(4)])


def test_frontend_concurrent_submitters_get_own_answers(engines):
    engine, ref = engines
    sets = [[i, i + 7] for i in range(12)]
    futs = {}
    with AsyncFrontEnd(MicroBatcher(engine, cache=ResultCache()),
                       default_deadline=0.05) as fe:
        def client(i):
            futs[i] = fe.submit_sigma(sets[i])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        got = {i: futs[i].result(timeout=30) for i in futs}
    want = engine.sigma(sets[:8]).tolist() + engine.sigma(sets[8:]).tolist()
    assert [got[i] for i in range(len(sets))] == want == _want(ref, sets)


def test_frontend_invalid_submit_fails_caller_only(engines):
    engine, ref = engines
    with AsyncFrontEnd(MicroBatcher(engine), default_deadline=0.05) as fe:
        ok = fe.submit_sigma([1, 2])
        with pytest.raises(ValueError):
            fe.submit_sigma(list(range(engine.max_seeds + 1)))
        assert ok.result(timeout=30) == engine.sigma([[1, 2]])[0] \
            == _want(ref, [[1, 2]])[0]


def test_frontend_close_drains_and_rejects(engines):
    engine, ref = engines
    fe = AsyncFrontEnd(MicroBatcher(engine), default_deadline=30.0)
    fut = fe.submit_sigma([5])
    fe.close()
    assert fut.result(timeout=5) == engine.sigma([[5]])[0] \
        == _want(ref, [[5]])[0]
    assert fe.stats.drain_flushes == 1
    with pytest.raises(RuntimeError):
        fe.submit_sigma([6])


def test_frontend_background_refresh_bumps_version():
    """The background refresh bumps the pool version while queries keep
    being answered; after the same refreshes, live `repro`'s pool answers
    the same at the answer's version and equals the port's at the end."""
    store, ref_store = _pair()
    engine, ref = QueryEngine(store), jserve.QueryEngine(ref_store)
    before = store.version
    with AsyncFrontEnd(MicroBatcher(engine, cache=ResultCache()),
                       default_deadline=0.02, refresh_every=0.2) as fe:
        deadline = time.monotonic() + 30
        while fe.stats.refreshes == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        # queries keep being answered across the epoch bump
        fut = fe.submit_sigma([2, 4])
        val = fut.result(timeout=30)
    assert fe.stats.refreshes >= 1
    assert store.version != before
    if fut.pool_version == store.version:
        assert val == engine.sigma([[2, 4]])[0]
    while ref_store.version != fut.pool_version:
        assert ref_store.epoch < store.epoch
        ref_store.refresh(fe.refresh_fraction)
    assert val == _want(ref, [[2, 4]])[0]
    while ref_store.version != store.version:
        ref_store.refresh(fe.refresh_fraction)
    assert ref_store.epoch == fe.stats.refreshes
    np.testing.assert_array_equal(
        store.visited_stack().numpy().view(np.uint32),
        np.asarray(ref_store.visited_stack()))


class _FlakyEngine:
    """Wraps a real engine; the first σ dispatch raises."""
    def __init__(self, inner):
        self.inner = inner
        self.query_slots = inner.query_slots
        self.max_seeds = inner.max_seeds
        self.fail_next = True

    @property
    def store(self):
        return self.inner.store

    def top_k(self, k):
        return self.inner.top_k(k)

    def sigma(self, seed_sets):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("boom")
        return self.inner.sigma(seed_sets)


def test_batcher_flush_error_names_consumed_tickets(engine):
    b = MicroBatcher(_FlakyEngine(engine))
    t1, t2 = b.submit_sigma([1]), b.submit_sigma([2])
    with pytest.raises(FlushError) as ei:
        b.flush()
    assert set(ei.value.tickets) == {t1, t2}
    b.submit_sigma([3])               # later submit untouched, still queued
    assert b.pending_count == 1


def test_batcher_flush_error_keeps_partial_results(engines):
    """A σ dispatch failure must not discard the top-k answer computed
    earlier in the same flush."""
    engine, ref = engines
    b = MicroBatcher(_FlakyEngine(engine))
    t_top = b.submit_top_k(2)
    t_sig = b.submit_sigma([1])
    with pytest.raises(FlushError) as ei:
        b.flush()
    assert set(ei.value.tickets) == {t_sig}
    seeds, sigma = ei.value.partial[t_top]
    ref_seeds, ref_sigma = engine.top_k(2)
    assert (seeds == ref_seeds).all() and sigma == ref_sigma
    j_seeds, j_sigma = ref.top_k(2)
    np.testing.assert_array_equal(seeds, np.asarray(j_seeds))
    assert sigma == j_sigma


def test_frontend_cancelled_future_does_not_kill_dispatcher(engines):
    """A client cancelling its queued future must not crash the dispatcher
    thread (futures are resolved via set_running_or_notify_cancel)."""
    engine, ref = engines
    with AsyncFrontEnd(MicroBatcher(engine), default_deadline=0.2) as fe:
        doomed = fe.submit_sigma([1])
        assert doomed.cancel()
        ok = fe.submit_sigma([2])
        assert ok.result(timeout=30) == engine.sigma([[2]])[0] \
            == _want(ref, [[2]])[0]


def test_frontend_flush_error_fails_only_consumed_callers(engines):
    """A broken dispatch fails the callers it consumed; the front-end keeps
    serving and later submits succeed."""
    engine, ref = engines
    with AsyncFrontEnd(MicroBatcher(_FlakyEngine(engine)),
                       default_deadline=0.05) as fe:
        bad = fe.submit_sigma([1])
        with pytest.raises(FlushError):
            bad.result(timeout=30)
        good = fe.submit_sigma([2])
        assert good.result(timeout=30) == engine.sigma([[2]])[0] \
            == _want(ref, [[2]])[0]


class _IntermittentEngine:
    """Wraps a real engine; every ``period``-th σ dispatch raises."""
    def __init__(self, inner, period=3):
        self.inner = inner
        self.query_slots = inner.query_slots
        self.max_seeds = inner.max_seeds
        self.period = period
        self.calls = 0

    @property
    def store(self):
        return self.inner.store

    def top_k(self, k):
        return self.inner.top_k(k)

    def sigma(self, seed_sets):
        self.calls += 1
        if self.calls % self.period == 0:
            raise RuntimeError("intermittent boom")
        return self.inner.sigma(seed_sets)


def test_batcher_stress_every_ticket_resolves_exactly_once(engine):
    """Many submitter threads racing flush() against intermittent dispatch
    failures: every ticket must end up answered exactly once OR named in
    exactly one FlushError.tickets — never both, never neither."""
    b = MicroBatcher(_IntermittentEngine(engine, period=3))
    submitted, answered, failed = set(), {}, []
    lock = threading.Lock()

    def submitter(base):
        for j in range(6):
            t = b.submit_sigma([base, base + j + 1])
            with lock:
                submitted.add(t)
            time.sleep(0.001)

    def flusher():
        for _ in range(20):
            try:
                out = b.flush()
            except FlushError as e:
                with lock:
                    failed.extend(e.tickets)
                    answered.update(e.partial)
            else:
                with lock:
                    answered.update(out)
            time.sleep(0.002)

    threads = ([threading.Thread(target=submitter, args=(i,))
                for i in range(6)]
               + [threading.Thread(target=flusher) for _ in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    while b.pending_count:                    # drain stragglers
        try:
            answered.update(b.flush())
        except FlushError as e:
            failed.extend(e.tickets)
            answered.update(e.partial)
    assert set(answered) | set(failed) == submitted
    assert not set(answered) & set(failed), \
        "a ticket must not be both answered and failed"
    assert len(failed) == len(set(failed)), \
        "a ticket must appear in at most one FlushError"
    assert failed, "period=3 over 20+ flushes must have tripped at least once"


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_frontend_close_fails_undrained_futures_instead_of_hanging(engine):
    """If the dispatcher dies on an unexpected (non-FlushError) exception,
    close() must fail the stranded futures with a clear FlushError rather
    than leaving callers blocked forever."""
    fe = AsyncFrontEnd(MicroBatcher(engine), default_deadline=30.0)
    fut = fe.submit_sigma([3])
    fe.batcher.flush = lambda: (_ for _ in ()).throw(RuntimeError("dead"))
    with fe._cv:
        fe._cv.notify_all()                   # nothing pending past deadline,
    fe.close()                                # so the dispatcher dies in drain
    with pytest.raises(FlushError) as ei:
        fut.result(timeout=5)
    assert "drained" in str(ei.value.__cause__)
    assert len(ei.value.tickets) == 1


def test_frontend_close_drain_failure_resolves_every_future(engines):
    """A flaky dispatch during the close() drain still resolves every
    submitted future — answers or FlushError, nothing left pending."""
    engine, ref = engines
    fe = AsyncFrontEnd(MicroBatcher(_FlakyEngine(engine)),
                       default_deadline=30.0)
    futs = [fe.submit_sigma([i]) for i in range(3)]
    fe.close()
    assert all(f.done() for f in futs), "close() must leave nothing pending"
    outcomes = []
    for i, f in enumerate(futs):
        try:
            outcomes.append(f.result(timeout=5))
        except FlushError:
            outcomes.append("failed")
        else:
            assert outcomes[-1] == _want(ref, [[i]])[0]
    assert "failed" in outcomes, "the flaky first dispatch must surface"


def test_result_cache_stats_snapshot(engine):
    cache = ResultCache()
    b = MicroBatcher(engine, cache=cache)
    b.submit_sigma([1, 2]), b.flush()
    b.submit_sigma([1, 2]), b.flush()          # same epoch ⇒ hit
    stats = cache.stats()
    assert stats["hits"] == 1 and stats["misses"] >= 1
    assert stats["size"] == len(cache)
    assert stats["hit_rate"] == pytest.approx(
        stats["hits"] / (stats["hits"] + stats["misses"]))
    assert set(stats) == {"hits", "misses", "size", "hit_rate"}


def test_batcher_deadline_bookkeeping(engine):
    b = MicroBatcher(engine)
    assert b.oldest_deadline() is None and b.pending_count == 0
    t0 = time.monotonic()
    b.submit_sigma([1], deadline=5.0)
    b.submit_sigma([2], deadline=1.0)
    b.submit_top_k(3)                       # no deadline
    assert b.pending_count == 3
    oldest = b.oldest_deadline()
    assert oldest is not None and 0.5 < oldest - t0 < 1.5
    b.flush()
    assert b.pending_count == 0 and b.oldest_deadline() is None


def test_batcher_threaded_submit_flush(engines):
    """Hammer submits from many threads against concurrent flushes; every
    ticket must be answered exactly once with its own query's answer."""
    engine, ref = engines
    b = MicroBatcher(engine, cache=ResultCache())
    results, lock = {}, threading.Lock()

    def submitter(base):
        tickets = [(b.submit_sigma([base, base + 3]), base) for _ in range(5)]
        with lock:
            results.update({t: base for t, base in tickets})

    def flusher():
        for _ in range(10):
            out = b.flush()
            with lock:
                flushed.update(out)
            time.sleep(0.005)

    flushed = {}
    threads = ([threading.Thread(target=submitter, args=(i,))
                for i in range(8)]
               + [threading.Thread(target=flusher) for _ in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    flushed.update(b.flush())               # drain stragglers
    assert set(flushed) == set(results), "every ticket answered exactly once"
    want = dict(zip(range(8), _want(ref, [[i, i + 3] for i in range(8)])))
    for ticket, base in results.items():
        assert flushed[ticket] == engine.sigma([[base, base + 3]])[0] \
            == want[base]


# ---------------------------------------- tests/test_serve_influence.py
@functools.lru_cache(maxsize=None)
def _serving_pair():
    """The reference's ``store`` fixture there (read only)."""
    return _pair(200, 6.0, 13, master_seed=3, batches=8, max_batches=32)


def test_batcher_rejects_oversized_seed_set_at_submit():
    """Invalid queries fail on the offending caller; a shared flush must
    never lose other callers' tickets to someone else's bad input."""
    store, ref_store = _serving_pair()
    b = MicroBatcher(QueryEngine(store, max_seeds=2))
    ok = b.submit_sigma([1, 2])
    with pytest.raises(ValueError):
        b.submit_sigma([1, 2, 3])
    out = b.flush()
    assert ok in out, "good ticket survives the rejected submit"
    assert out[ok] == jserve.QueryEngine(ref_store, max_seeds=2).sigma(
        [[1, 2]])[0]


def test_engine_results_are_read_only():
    """Results are shared via cache/dedup fan-out — mutation must fail loudly
    instead of corrupting another caller's answer."""
    store, ref_store = _serving_pair()
    eng, ref = QueryEngine(store), jserve.QueryEngine(ref_store)
    gains = eng.marginal_gains([1])
    np.testing.assert_array_equal(gains, np.asarray(ref.marginal_gains([1])))
    with pytest.raises(ValueError):
        gains[0] = 1.0
    seeds, _ = eng.top_k(2)
    np.testing.assert_array_equal(seeds, np.asarray(ref.top_k(2)[0]))
    with pytest.raises(ValueError):
        seeds[0] = 0


def test_cache_invalidates_on_epoch_bump():
    s, sj = _pair(200, 6.0, 13, master_seed=21)
    cache = ResultCache()
    b = MicroBatcher(QueryEngine(s), cache=cache)
    t1 = b.submit_sigma([1, 2, 3])
    r1 = b.flush()
    t2 = b.submit_sigma([3, 2, 1])
    r2 = b.flush()
    assert cache.hits == 1 and b.dispatches == 1, "canonical-key cache hit"
    assert r1[t1] == r2[t2] == jserve.QueryEngine(sj).sigma([[1, 2, 3]])[0]
    old_version = s.version
    assert s.refresh(0.5) == sj.refresh(0.5)
    assert s.version != old_version and s.version == sj.version
    t3 = b.submit_sigma([1, 2, 3])
    r3 = b.flush()
    assert b.dispatches == 2, "epoch bump must force a recompute"
    assert cache.hits == 1
    assert r3[t3] == jserve.QueryEngine(sj).sigma([[1, 2, 3]])[0]


def test_cache_invalidates_on_pool_growth():
    s, sj = _pair(200, 6.0, 13, master_seed=22, batches=2)
    cache = ResultCache()
    b = MicroBatcher(QueryEngine(s), cache=cache)
    t1 = b.submit_sigma([4])
    r1 = b.flush()
    assert r1[t1] == jserve.QueryEngine(sj).sigma([[4]])[0]
    s.ensure(4)                       # growth changes the estimator
    sj.ensure(4)
    t2 = b.submit_sigma([4])
    r2 = b.flush()
    assert b.dispatches == 2
    assert s.version == sj.version
    assert r2[t2] == jserve.QueryEngine(sj).sigma([[4]])[0]


def test_refresh_replaces_oldest_and_never_reuses_streams():
    s, sj = _pair(200, 6.0, 13, master_seed=31)
    before = {b.batch_index for b in s.batches}
    slots = s.refresh(0.5)
    assert len(slots) == 2 and s.epoch == 1
    after = [b.batch_index for b in s.batches]
    assert len(set(after)) == 4
    for i in slots:
        assert after[i] not in before, "refresh must use fresh RNG streams"
        assert s.batch_epochs[i] == 1
    # Second refresh picks the remaining epoch-0 batches first.
    slots2 = s.refresh(0.5)
    assert set(slots2) == set(range(4)) - set(slots)
    assert [slots, slots2] == [sj.refresh(0.5), sj.refresh(0.5)]
    assert [b.batch_index for b in s.batches] == \
        [b.batch_index for b in sj.batches]
    assert s.batch_epochs == sj.batch_epochs
    np.testing.assert_array_equal(s.visited_stack().numpy().view(np.uint32),
                                  np.asarray(sj.visited_stack()))


# ------------------------------------------------- the launcher's --async
def test_launcher_smoke_async_on_one_device(capfd):
    """``--smoke --async`` runs the lifecycle, then the front end under
    threaded clients: a lone request flushes on its deadline, and no
    request waits past it by more than the reference's bound."""
    out = tlaunch.main(["--device", "cpu", "--smoke", "--async"])
    stats = out["async"]["stats"]
    assert stats["deadline_flushes"] >= 1 and stats["served"] >= 33
    assert stats["max_queue_wait"] <= 0.05 + 2.0
    text = capfd.readouterr().out
    assert "[async]" in text and "[smoke] PASS" in text
    assert text.index("[async]") < text.index("[smoke] PASS")
