"""Per-tenant token-bucket admission control (PyTorch port of
``repro.serve.tier.quota``; plain Python).

Sits *in front of* submit: a query that would oversubscribe its tenant's
bucket is shed with a retriable `ShedError` **before** it touches a
batcher, so an over-quota tenant can never occupy engine slots, poison a
shared flush, or crowd a deadline — the blast radius of a hot tenant is
exactly its own traffic.

Each tenant owns one token bucket (``rate`` tokens/s refill, ``burst``
capacity) refilled lazily from a monotonic clock on every admission
attempt, so there is no refill thread and an idle tenant costs nothing.
`ShedError.retry_after` tells the client exactly when the bucket will
next hold the tokens its request needs — the contract an open-loop load
generator (and a well-behaved client) uses to back off instead of
hammering.

The clock is injectable for deterministic tests.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time

from repro_torch.serve.tier.metrics import escape_label


class ShedError(RuntimeError):
    """Request shed by admission control; retriable after ``retry_after``.

    ``retry_after`` (seconds) is when the tenant's bucket will have refilled
    enough for this request's cost; ``tenant`` names the throttled tenant.
    ``retry_after`` is ``math.inf`` when the request can NEVER be admitted
    (``cost`` exceeds the bucket's burst capacity) — don't retry those.
    """

    def __init__(self, tenant: str, retry_after: float, cost: float = 1.0):
        if math.isinf(retry_after):
            msg = (f"tenant {tenant!r}: cost {cost:g} exceeds burst "
                   "capacity — never admissible; do not retry")
        else:
            msg = f"tenant {tenant!r} over quota: retry in {retry_after:.3f}s"
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after = retry_after
        self.cost = cost


@dataclasses.dataclass
class _Bucket:
    rate: float         # tokens per second
    burst: float        # bucket capacity
    tokens: float       # current fill
    stamp: float        # last refill time (clock units)

    def refill(self, now: float) -> None:
        self.tokens = min(self.burst, self.tokens + (now - self.stamp)
                          * self.rate)
        self.stamp = now


class AdmissionController:
    """Token-bucket admission over named tenants.

    Unknown tenants get the default (``rate``/``burst``) on first sight;
    ``set_quota`` pins a per-tenant override (e.g. a paid tier).  A
    ``rate`` of ``None`` (or ``float("inf")``) means unmetered.
    """

    def __init__(self, rate: float | None = 100.0, burst: float | None = None,
                 *, clock=time.monotonic, metrics=None):
        self.default_rate = rate
        self.default_burst = burst
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}

    def _make_bucket(self, rate: float | None,
                     burst: float | None) -> _Bucket | None:
        if rate is None or rate == float("inf"):
            return None                     # unmetered tenant
        burst = burst if burst is not None else max(1.0, rate)
        return _Bucket(rate=float(rate), burst=float(burst),
                       tokens=float(burst), stamp=self._clock())

    def set_quota(self, tenant: str, rate: float | None,
                  burst: float | None = None) -> None:
        with self._lock:
            self._buckets[tenant] = self._make_bucket(rate, burst)

    def quota(self, tenant: str) -> tuple[float, float] | None:
        """(rate, burst) for a tenant, or None when unmetered."""
        with self._lock:
            if tenant not in self._buckets:
                self._buckets[tenant] = self._make_bucket(
                    self.default_rate, self.default_burst)
            b = self._buckets[tenant]
        return None if b is None else (b.rate, b.burst)

    # ------------------------------------------------------------- admit
    def admit(self, tenant: str, cost: float = 1.0) -> None:
        """Take ``cost`` tokens from the tenant's bucket or raise `ShedError`.

        The shed path never blocks and never takes partial tokens — a shed
        request leaves the bucket exactly as it found it, so retrying at
        ``retry_after`` genuinely succeeds absent competing traffic.  A
        ``cost`` above the bucket's burst capacity can never be satisfied
        by waiting (tokens cap at burst); it sheds with
        ``retry_after=math.inf`` so clients don't retry forever on a
        finite hint that can never come true.
        """
        with self._lock:
            if tenant not in self._buckets:
                self._buckets[tenant] = self._make_bucket(
                    self.default_rate, self.default_burst)
            bucket = self._buckets[tenant]
            if bucket is None:
                self._count(tenant, "admitted")
                return
            if cost > bucket.burst:
                retry_after = math.inf
            else:
                bucket.refill(self._clock())
                if bucket.tokens >= cost:
                    bucket.tokens -= cost
                    self._count(tenant, "admitted")
                    return
                retry_after = (cost - bucket.tokens) / bucket.rate
        self._count(tenant, "shed")
        raise ShedError(tenant, retry_after, cost)

    def _count(self, tenant: str, what: str) -> None:
        if self._metrics is not None:
            # Tenant ids are user-supplied: escape so a dotted id (e.g.
            # "org.acme") can't nest under extra snapshot levels and fall
            # out of the tier's admitted/shed totals.
            self._metrics.counter(
                f"tenant.{escape_label(tenant)}.{what}").add()
