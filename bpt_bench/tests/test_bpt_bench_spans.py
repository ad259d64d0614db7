"""The readers of the program's spans and counters (`bpt_bench.spans`), on
hand-built registry snapshots: the self-time arithmetic, and no value
where a span is absent or the program keeps no registry."""
from __future__ import annotations

import sys

import pytest

from bpt_bench import spans, spec

MS = 1_000_000                   # ns


def _rec(spans_, counters=None) -> dict:
    return {spans.KEY: {"spans": spans_, "counters": counters or {},
                        "dropped": 0}}


# One refresh of one batch, two levels: 10 ms in all, the first frontier's
# test 0.1 ms, levels of 1 and 2 ms waiting 0.3 and 0.5 ms.
BUILD = [
    ("store.refresh", 0, 10 * MS, None, None),                     # 0
    ("sampler.batch", MS // 10, 9 * MS, 0, 7),                     # 1
    ("sampler.setup", MS // 10, MS // 2, 1, 7),                    # 2
    ("frontier.init", MS // 2, MS, 2, 7),                          # 3
    ("level.sync", MS, 11 * MS // 10, 1, 7),                       # 4
    ("level", 2 * MS, 3 * MS, 1, 7),                               # 5
    ("level.expand", 2 * MS, 24 * MS // 10, 5, 7),                 # 6
    ("level.sync", 25 * MS // 10, 28 * MS // 10, 5, 7),            # 7
    ("level", 3 * MS, 5 * MS, 1, 7),                               # 8
    ("level.sync", 4 * MS, 45 * MS // 10, 8, 7),                   # 9
]
BUILD_COUNTERS = {"sampler.syncs": 3, "sampler.levels": 2}

# Two flushes: 8 ms reading 0.5 + 2 ms, and 2 ms of cache hits alone.
QUERY = [
    ("batcher.flush", 0, 8 * MS, None, 0),                         # 0
    ("batcher.lookup", 0, MS, 0, 0),                               # 1
    ("engine.sigma", MS, 3 * MS, 0, 0),                            # 2
    ("engine.sigma.read", 2 * MS, 25 * MS // 10, 2, 0),            # 3
    ("engine.marginal", 3 * MS, 7 * MS, 0, 0),                     # 4
    ("engine.marginal.read", 4 * MS, 6 * MS, 4, 0),                # 5
    ("batcher.flush", 10 * MS, 12 * MS, None, 1),                  # 6
    ("batcher.lookup", 10 * MS, 11 * MS, 6, 1),                    # 7
]

WANT = {
    "level_host_us": (BUILD, 1e3 * (3.0 - 0.8) / 2),
    "level_wait_us": (BUILD, 1e3 * (0.1 + 0.3 + 0.5) / 2),
    "syncs_per_level": (BUILD, 1.5),
    "batch_host_ms": (BUILD, 10.0 - 3.0 - 0.1),
    "flush_host_ms": (QUERY, (8.0 + 2.0 - 0.5 - 2.0) / 2),
    "flush_wait_ms": (QUERY, (0.5 + 2.0) / 2),
}
# What each reader cannot do without.
NEEDS = {"level_host_us": "level", "level_wait_us": "level.sync",
         "batch_host_ms": "sampler.batch", "flush_host_ms": "batcher.flush",
         "flush_wait_ms": "batcher.flush"}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_on_a_hand_built_snapshot(name):
    snap, want = WANT[name]
    got = spec.reader(name)(_rec(snap, BUILD_COUNTERS))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(NEEDS))
def test_a_reader_gives_none_without_its_span(name):
    snap, _ = WANT[name]
    kept = [s for s in snap if s[0] != NEEDS[name]]
    # Keep parent indices pointing at the same spans.
    index = {id(s): i for i, s in enumerate(kept)}
    renumbered = [(n, a, b, None if p is None or id(snap[p]) not in index
                   else index[id(snap[p])], r) for n, a, b, p, r in kept]
    assert spec.reader(name)(_rec(renumbered, BUILD_COUNTERS)) is None


def test_syncs_per_level_gives_none_without_its_counters():
    read = spec.reader("syncs_per_level")
    assert read(_rec(BUILD)) is None
    assert read(_rec(BUILD, {"sampler.levels": 2})) is None
    assert read(_rec(BUILD, {"sampler.syncs": 3, "sampler.levels": 0})) \
        is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_program_without_a_registry_gives_none(name, monkeypatch):
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    rec = {}
    assert spec.reader(name)(rec) is None
    assert rec[spans.KEY] is None


def test_the_registry_is_taken_once_a_record():
    import torch
    from repro_torch import tracing
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("batcher.flush", 0):
            tracing.count("sampler.syncs")
    rec = {}
    s = spans.of(rec)
    assert s.count("batcher.flush") == 1 and s.counter("sampler.syncs") == 1
    assert tracing.snapshot()["spans"] == []          # emptied
    assert spans.of(rec).count("batcher.flush") == 1  # kept in the record
    assert spans.of({}).count("batcher.flush") == 0   # a later run's own
