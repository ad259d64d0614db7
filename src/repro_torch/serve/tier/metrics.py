"""Lock-cheap serving metrics: counters + log-bucketed latency histograms
(PyTorch port of ``repro.serve.tier.metrics``; plain Python).

Every tier component (admission controller, replica router, autoscaler,
front door) exports its observability through one `MetricSet`:

* `Counter` — a monotonically-increasing integer behind a per-counter lock
  (the critical section is one add, never a dispatch);
* `Histogram` — latencies recorded into geometrically-spaced buckets, so
  ``record()`` is a bisect + one locked increment and quantiles
  (p50/p99/p999) come from the bucket CDF with no sample retention;
* `MetricSet.snapshot()` — a JSON-serializable dict of every metric, each
  read atomically (counters under their own lock, histogram counts copied
  in one acquisition), suitable for a scrape endpoint or the SLO
  load-generator's per-cell records.

Nothing here touches the device: metrics are pure host bookkeeping, cheap enough
to sit on the submit path of every query.
"""
from __future__ import annotations

import bisect
import json
import math
import threading


def escape_label(label: str) -> str:
    """Metric-name-safe form of a user-supplied label (e.g. a tenant id).

    Metric names are dotted paths and `MetricSet.snapshot` nests them by
    splitting on ``"."``, so a dot inside a label would nest that tenant's
    counters one level deeper (and drop them from the tier's totals).
    Percent-escaping ``%`` then ``.`` is injective — distinct labels can
    never collide after escaping — and keeps names ASCII and readable
    (``"org.acme"`` → ``"org%2Eacme"``).
    """
    return label.replace("%", "%25").replace(".", "%2E")


class Counter:
    """Thread-safe monotonic counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


def _default_bounds() -> list[float]:
    """Geometric bucket upper bounds: 50 µs … ~520 s, ×1.4 per bucket
    (~42 buckets — ≤ ±20% quantile resolution, plenty for SLO tails)."""
    bounds, b = [], 50e-6
    while b < 600.0:
        bounds.append(b)
        b *= 1.4
    return bounds


class Histogram:
    """Latency histogram with bucket-CDF quantiles (seconds in, seconds out)."""

    def __init__(self, bounds: list[float] | None = None):
        self._bounds = list(bounds) if bounds is not None else _default_bounds()
        self._lock = threading.Lock()
        self._counts = [0] * (len(self._bounds) + 1)    # +1 overflow bucket
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def record(self, seconds: float) -> None:
        i = bisect.bisect_left(self._bounds, seconds)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += seconds
            if seconds > self._max:
                self._max = seconds

    def _copy(self):
        with self._lock:
            return list(self._counts), self._count, self._sum, self._max

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket where the CDF crosses ``q`` (0 when
        empty; the observed max for the overflow bucket)."""
        counts, total, _, mx = self._copy()
        if total == 0:
            return 0.0
        rank, seen = math.ceil(q * total), 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                return self._bounds[i] if i < len(self._bounds) else mx
        return mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        counts, total, s, mx = self._copy()
        out = {"count": total, "mean": (s / total) if total else 0.0,
               "max": mx}
        for name, q in (("p50", 0.50), ("p99", 0.99), ("p999", 0.999)):
            out[name] = self.quantile(q)
        return out


class MetricSet:
    """Named counters + histograms with one atomic-per-metric snapshot.

    Metrics are created on first use (``counter(name)`` / ``hist(name)``),
    so components never pre-declare; names are dotted paths
    (``"tenant.alice.admitted"``, ``"router.replica0.dispatch_s"``) and the
    snapshot nests them back into a tree for readable JSON.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def hist(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    @staticmethod
    def _nest(tree: dict, name: str, value) -> None:
        parts = name.split(".")
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = value

    def snapshot(self) -> dict:
        """JSON-serializable tree of every metric (each metric atomic)."""
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
        tree: dict = {}
        for name, c in sorted(counters.items()):
            self._nest(tree, name, c.value)
        for name, h in sorted(hists.items()):
            self._nest(tree, name, h.snapshot())
        return tree

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.snapshot(), **dump_kw)
