"""The level loop's waits on the device a BFS level, in us: every
``level.sync`` span (a blocking read of a frontier's test, the first
frontier's included), over the ``level`` spans (`bpt_bench.spans`)."""
from bpt_bench import spans


def read(rec: dict):
    s = spans.of(rec)
    if s is None or not s.count("level") or not s.count("level.sync"):
        return None
    return 1e6 * s.seconds("level.sync") / s.count("level")
