"""The coverage kernel's share of its roofline over the profiled slice:
its launches' least time (`bpt_bench.work.cover_counts` over the whole
pool), over its device time."""
from bpt_bench import work

KERNEL = "cover_counts"


def read(rec: dict):
    w = (rec.get("work") or {}).get("cover_counts_launch")
    kernels = (rec.get("trace") or {}).get("kernels", {})
    hits = [(t, n) for name, (t, n) in kernels.items() if KERNEL in name]
    spent = sum(t for t, _ in hits)
    launches = sum(n for _, n in hits)
    if not w or spent <= 0:
        return None
    return 100.0 * launches * work.bound_s(w["ops"], w["bytes"]) / spent
