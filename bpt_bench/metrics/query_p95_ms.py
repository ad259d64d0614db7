"""The 95th percentile of every answered query's latency, arrival to
answer, in ms (numpy's linear interpolation)."""
import numpy as np


def read(rec: dict):
    lat = rec.get("latency_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95))
