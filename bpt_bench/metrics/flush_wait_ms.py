"""A flush's blocking reads of counts, in ms: the ``engine.sigma.read``
and ``engine.marginal.read`` spans over the ``batcher.flush`` spans
(`bpt_bench.spans`)."""
from bpt_bench import spans

READS = ("engine.sigma.read", "engine.marginal.read")


def read(rec: dict):
    s = spans.of(rec)
    if s is None or not s.count("batcher.flush"):
        return None
    return 1e3 * sum(s.seconds(r) for r in READS) / s.count("batcher.flush")
