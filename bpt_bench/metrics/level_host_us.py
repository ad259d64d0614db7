"""Host time a BFS level inside the program, in us: the ``level`` spans
less their blocking reads (``level.sync`` directly inside them), over the
levels (`bpt_bench.spans`)."""
from bpt_bench import spans


def read(rec: dict):
    s = spans.of(rec)
    if s is None or not s.count("level"):
        return None
    host = s.seconds("level") - s.seconds("level.sync", parent="level")
    return 1e6 * host / s.count("level")
