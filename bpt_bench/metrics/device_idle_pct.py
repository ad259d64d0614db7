"""The device's idle share of the profiled slice: 1 - (union of its
kernel, copy and memset intervals) / the slice's host-clock length."""


def read(rec: dict):
    t = rec.get("trace") or {}
    if t.get("window_s", 0) <= 0 or t.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
