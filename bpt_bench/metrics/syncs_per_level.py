"""Blocking device reads a BFS level: the program's counters
``sampler.syncs`` over ``sampler.levels`` (`bpt_bench.spans`)."""
from bpt_bench import spans


def read(rec: dict):
    s = spans.of(rec)
    if s is None or not s.counter("sampler.levels") \
            or s.counter("sampler.syncs") is None:
        return None
    return s.counter("sampler.syncs") / s.counter("sampler.levels")
