"""`repro_torch.tracing`: the spans and counters of the pool refresh and the
query flush, on CPU tensors (the kernels' plain versions).

Off, a span is one shared object and nothing is kept; on (while a
profiler runs), each batch is a ``sampler.batch`` holding one
``level`` a BFS level, each flush a ``batcher.flush`` holding its reads,
the counters count where the work happens, and the profiler sees the
spans as CPU ranges of ``FUNCTION`` scope.  Masks and answers are the
same either way.
"""
import os
import sys
import threading

import pytest
import torch

from repro_torch import tracing
from repro_torch.graph import csr, generators
from repro_torch.sampling import SamplerSpec, make_sampler
from repro_torch.serve.influence import (MicroBatcher, PoolConfig,
                                         QueryEngine, ResultCache,
                                         SketchStore)

torch.set_num_threads(1)

GRAPH = dict(n=150, avg_deg=5.0, prob=0.25, seed=17)


@pytest.fixture
def registry():
    """An empty registry, emptied again after the test."""
    tracing.reset()
    try:
        yield
    finally:
        tracing.reset()


def _recording():
    """A CPU profile, during which the program records."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _graph():
    return csr.dedupe(generators.powerlaw_cluster(**GRAPH, device="cpu"))


def _spec(**kw):
    return SamplerSpec(**dict(dict(backend="kernel", num_colors=64,
                                   master_seed=9, tile_size=32), **kw))


def _children(spans, parent: int, name: str) -> list[int]:
    return [i for i, s in enumerate(spans)
            if s[3] == parent and s[0] == name]


def _descendants(spans, root: int) -> set[str]:
    out, todo = set(), [root]
    while todo:
        p = todo.pop()
        for i, s in enumerate(spans):
            if s[3] == p:
                out.add(s[0])
                todo.append(i)
    return out


def test_off_a_span_is_one_shared_object_and_nothing_is_kept(registry):
    a, b = tracing.span("level"), tracing.span("sampler.batch", 3)
    assert a is b
    with a:
        tracing.count("sampler.levels", 5)
    with pytest.raises(KeyError):
        with tracing.span("level"):
            raise KeyError("passes through")
    make_sampler(_graph(), _spec()).sample(0)
    assert tracing.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


@pytest.mark.parametrize("frontier", ["dense", "sparse"])
@pytest.mark.parametrize("max_iters", [1, 64])
def test_each_batch_is_a_span_holding_one_level_span_a_level(
        registry, frontier, max_iters):
    sampler = make_sampler(_graph(), _spec(max_iters=max_iters,
                                           frontier=frontier))
    levels = {}
    with _recording():
        for b in range(4):
            sampler.sample(b)
            levels[b] = sampler.last_levels
    snap = tracing.snapshot()
    spans = snap["spans"]
    batches = [i for i, s in enumerate(spans) if s[0] == "sampler.batch"]
    assert [spans[i][4] for i in batches] == list(levels)
    capped = 0
    for i in batches:
        b = spans[i][4]
        lv = _children(spans, i, "level")
        assert len(lv) == levels[b]
        assert all(spans[j][4] == b for j in lv)          # rid inherited
        for j in lv:
            assert _children(spans, j, "level.expand")
        assert _children(spans, i, "sampler.setup")
        assert _children(spans, i, "frontier.init")
        capped += levels[b] == max_iters
    assert capped == (len(levels) if max_iters == 1 else 0)
    total = sum(levels.values())
    # One test a frontier (the last one not run at the cap), and on the
    # sparse frontier one compaction a level.
    tests = total + len(levels) - capped
    compactions = total if frontier == "sparse" else 0
    assert snap["counters"] == {"sampler.levels": total,
                                "sampler.syncs": tests + compactions}
    assert sum(s[0] == "level.sync" for s in spans) == tests
    assert all(s[2] >= s[1] for s in spans)
    assert all(s[3] is None or spans[s[3]][1] <= s[1] for s in spans)


def test_a_span_is_kept_when_it_closes(registry):
    with _recording(), tracing.span("outer", 4):
        with tracing.span("inner"):
            pass
        (inner,) = tracing.snapshot()["spans"]
    assert inner[0] == "inner" and inner[3] is None and inner[4] == 4
    outer, inner = tracing.snapshot()["spans"]
    assert outer[0] == "outer" and inner[3] == 0


def test_a_refresh_holds_its_batches_and_the_stack_update(registry):
    store = SketchStore(_graph(), PoolConfig(max_batches=4, spec=_spec()))
    store.ensure(4)
    store.visited_stack()
    with _recording():
        store.refresh(0.5)
    spans = tracing.snapshot()["spans"]
    assert spans[0][0] == "store.refresh" and spans[0][3] is None
    assert [spans[i][4] for i in _children(spans, 0, "sampler.batch")] \
        == [4, 5]
    assert len(_children(spans, 0, "store.update")) == 1


def _front(batches=4):
    store = SketchStore(_graph(), PoolConfig(max_batches=batches,
                                             spec=_spec()))
    store.ensure(batches)
    store.visited_stack()
    return MicroBatcher(QueryEngine(store, query_slots=4, max_seeds=4),
                        cache=ResultCache())


QUERIES = [("sigma", [1, 2]), ("sigma", [7]), ("marginal", [3]),
           ("marginal", [4, 5, 6])]


def _ask(batcher):
    tickets = [getattr(batcher, f"submit_{kind}")(q) for kind, q in QUERIES]
    out = batcher.flush()
    return [out[t] for t in tickets]


def test_a_flush_is_a_span_holding_both_reads(registry):
    batcher = _front()
    batcher.flush()                                # rid 0, untraced
    with _recording():
        _ask(batcher)                              # rid 1
        _ask(batcher)                              # rid 2: every answer hit
    snap = tracing.snapshot()
    spans = snap["spans"]
    flushes = [i for i, s in enumerate(spans) if s[0] == "batcher.flush"]
    assert [spans[i][4] for i in flushes] == [1, 2]
    first = _descendants(spans, flushes[0])
    assert {"batcher.lookup", "engine.pad", "engine.sigma",
            "engine.sigma.count", "engine.sigma.read", "engine.sigma.scale",
            "engine.marginal", "engine.marginal.read",
            "engine.marginal.scale", "batcher.store"} <= first
    assert all(s[4] == 1 for s in spans if s[0].startswith("engine."))
    assert _descendants(spans, flushes[1]) == {"batcher.lookup"}


def test_the_profiler_sees_function_scope_cpu_ranges(registry):
    sampler = make_sampler(_graph(), _spec())
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        with torch.profiler.record_function("outer"):
            sampler.sample(0)
    assert tracing.span("level") is tracing.span("level")     # off again
    events = {}
    for ev in prof.events():
        events.setdefault(ev.name, []).append(ev)
    (outer,) = events["outer"]
    assert outer.is_user_annotation
    for name in ("sampler.batch", "sampler.setup", "frontier.init", "level",
                 "level.expand", "level.sync"):
        for ev in events[name]:
            assert ev.device_type == torch.autograd.DeviceType.CPU
            assert not ev.is_user_annotation
            assert outer.time_range.start <= ev.time_range.start \
                <= ev.time_range.end <= outer.time_range.end
    (batch,) = events["sampler.batch"]
    assert batch.cpu_parent.name == "outer"
    assert len(events["level"]) == sampler.last_levels
    kept = tracing.snapshot()["spans"]
    assert sum(s[0] == "level" for s in kept) == sampler.last_levels


def test_masks_and_answers_are_the_same_traced_or_not(registry):
    sampler = make_sampler(_graph(), _spec(frontier="sparse"))
    plain = [sampler.sample(b).visited for b in range(3)]
    plain_answers = _ask(_front())
    with _recording():
        traced = [sampler.sample(b).visited for b in range(3)]
        traced_answers = _ask(_front())
    assert tracing.snapshot()["spans"]
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    for a, b in zip(plain_answers, traced_answers):
        assert a.tobytes() == b.tobytes()


def test_each_thread_nests_its_own_spans(registry):
    ready = threading.Barrier(2, timeout=30)

    def work(rid):
        with tracing.span("outer", rid):
            ready.wait()
            with tracing.span("inner"):
                ready.wait()

    threads = [threading.Thread(target=work, args=(r,)) for r in (1, 2)]
    with _recording():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.snapshot()["spans"]
    for i, (name, _, _, parent, rid) in enumerate(spans):
        if name == "inner":
            assert spans[parent][0] == "outer" and spans[parent][4] == rid
        else:
            assert parent is None


def test_threads_past_the_cores_lose_no_span_or_count(registry):
    """More threads than cores, switching every microsecond: every span
    and every count arrives, each nested under its own thread's outer."""
    workers, rounds = (os.cpu_count() or 1) + 4, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(rid):
            for _ in range(rounds):
                with tracing.span("outer", rid):
                    with tracing.span("inner"):
                        tracing.count("n")
                    tracing.count("m", 2)

        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(workers)]
        with _recording():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap["counters"] == {"n": workers * rounds,
                                "m": 2 * workers * rounds}
    assert snap["dropped"] == 0
    spans = snap["spans"]
    assert len(spans) == 2 * workers * rounds
    for name, _, _, parent, rid in spans:
        if name == "inner":
            assert spans[parent][0] == "outer" and spans[parent][4] == rid
        else:
            assert parent is None


def test_spans_past_the_cap_are_counted_not_kept(registry, monkeypatch):
    """Spans are kept as they close: the inner two here."""
    monkeypatch.setattr(tracing, "CAP", 2)
    with _recording(), tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                with tracing.span("d"):
                    pass
    snap = tracing.snapshot()
    assert snap["spans"][0][0] == "c" and snap["spans"][1][0] == "d"
    assert snap["spans"][0][3] is None and snap["spans"][1][3] == 0
    assert snap["dropped"] == 2
    tracing.reset()
    assert tracing.snapshot() == {"spans": [], "counters": {}, "dropped": 0}
