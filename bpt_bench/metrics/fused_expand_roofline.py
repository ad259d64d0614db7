"""The IC tile kernel's share of its roofline over the profiled slice: the
least time for the slice's batches' work (`bpt_bench.work`: their levels'
bytes, their live draws; none for a batch at the level cap), over the
kernel's device time."""
from bpt_bench import work

KERNEL = "IcGate"          # the IC gate of csrc/fused_expand.cu


def read(rec: dict):
    w = rec.get("work")
    kernels = (rec.get("trace") or {}).get("kernels", {})
    spent = sum(t for name, (t, _) in kernels.items() if KERNEL in name)
    if not w or "ops" not in w or spent <= 0:
        return None
    return 100.0 * work.bound_s(w["ops"], w["bytes"]) / spent
