"""A batch's time outside its level loop, in ms: the ``store.refresh``
spans less the ``level`` spans and the ``level.sync`` spans outside them
(the first frontier's test), over the ``sampler.batch`` spans
(`bpt_bench.spans`): roots, the first frontier, the stack's update."""
from bpt_bench import spans


def read(rec: dict):
    s = spans.of(rec)
    if s is None or not s.count("store.refresh") \
            or not s.count("sampler.batch"):
        return None
    rest = s.seconds("store.refresh") - s.seconds("level") \
        - s.seconds("level.sync", outside="level")
    return 1e3 * rest / s.count("sampler.batch")
