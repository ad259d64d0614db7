"""A flush's time outside its blocking reads, in ms: the
``batcher.flush`` spans less the ``engine.sigma.read`` and
``engine.marginal.read`` spans, over the flushes (`bpt_bench.spans`)."""
from bpt_bench import spans

READS = ("engine.sigma.read", "engine.marginal.read")


def read(rec: dict):
    s = spans.of(rec)
    if s is None or not s.count("batcher.flush"):
        return None
    host = s.seconds("batcher.flush") - sum(s.seconds(r) for r in READS)
    return 1e3 * host / s.count("batcher.flush")
