"""The tier front door: admission → routing → metrics, one object
(PyTorch port of ``repro.serve.tier.service``).

`ServingTier` is what a process serves traffic through:

    tier = ServingTier.build(store, replicas=2,
                             quota_qps=50.0, default_deadline=0.02)
    tier.set_quota("free-tier", rate=5.0, burst=10)
    fut = tier.submit_sigma("alice", [3, 17, 42])    # ShedError if over quota
    sigma = fut.result()
    print(tier.to_json(indent=1))                    # SLO snapshot
    tier.close()

Every submit: (1) the tenant's token bucket admits or sheds
(`quota.ShedError` carries retry-after — raised on the caller, nothing
reaches an engine); (2) the router picks a replica (least-pending by
default); (3) a done-callback records the submit→resolve latency into the
tier histogram (per-query-kind + overall) and counts per-tenant serves.
`gather()` re-exports the router's epoch-consistency guard.

`snapshot()` is the JSON observability surface: tenant admit/shed/served
counts, shed rate, latency percentiles (p50/p99/p999), per-replica
dispatch counts + queue depth + pool version, cache hit rates (through
`ResultCache.stats()` — the atomic snapshot), and the autoscaler's last
decision when one is attached.  Tenant ids appear under
`metrics.escape_label` form (``"org.acme"`` → ``"org%2Eacme"``) so a
dotted id can't nest deeper than the ``tenant.<id>.<counter>`` level the
totals sum over.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time

from repro_torch.serve.tier import metrics as metrics_lib
from repro_torch.serve.tier import quota as quota_lib
from repro_torch.serve.tier import router as router_lib
from repro_torch.serve.tier.autoscale import AutoScaler


class ServingTier:
    """Per-tenant admission + replica routing + metrics over one pool."""

    def __init__(self, group: router_lib.ReplicaGroup,
                 admission: quota_lib.AdmissionController, *,
                 metrics: metrics_lib.MetricSet | None = None,
                 autoscaler: AutoScaler | None = None):
        self.group = group
        self.admission = admission
        self.metrics = metrics if metrics is not None else \
            metrics_lib.MetricSet()
        self.autoscaler = autoscaler
        self._tracker = None        # DirtySlotTracker, lazy (first delta)
        self._last_stream = None    # last stream.StreamReport
        self._compactor: threading.Thread | None = None
        self._compact_stop = threading.Event()

    @classmethod
    def build(cls, store, replicas: int = 2, *,
              engine_factory=router_lib.QueryEngine,
              policy: str = "least_pending",
              quota_qps: float | None = 100.0, quota_burst: float | None = None,
              autoscale: dict | None = None,
              **frontend_kw) -> "ServingTier":
        """Assemble the whole tier from one warm store.

        ``autoscale``: kwargs for `AutoScaler` (e.g. ``{"k": 4,
        "target_eps": 0.3, "target_p99_ms": 50}``) — the scaler is wired to
        the tier's latency histogram and started by ``start_background``.
        """
        metrics = metrics_lib.MetricSet()
        group = router_lib.ReplicaGroup.build(
            store, replicas, engine_factory=engine_factory, policy=policy,
            metrics=metrics, **frontend_kw)
        admission = quota_lib.AdmissionController(
            quota_qps, quota_burst, metrics=metrics)
        scaler = None
        if autoscale is not None:
            scaler = AutoScaler(group, metrics=metrics,
                                latency_hist=metrics.hist("latency.all"),
                                **autoscale)
        return cls(group, admission, metrics=metrics, autoscaler=scaler)

    # ------------------------------------------------------------- submit
    def set_quota(self, tenant: str, rate: float | None,
                  burst: float | None = None) -> None:
        self.admission.set_quota(tenant, rate, burst)

    def _submit(self, tenant: str, kind: str, payload, deadline, cost):
        self.admission.admit(tenant, cost)      # ShedError propagates
        t0 = time.monotonic()
        fut = getattr(self.group, f"submit_{kind}")(payload,
                                                    deadline=deadline)
        hist_all = self.metrics.hist("latency.all")
        hist_kind = self.metrics.hist(f"latency.{kind}")
        served = self.metrics.counter(
            f"tenant.{metrics_lib.escape_label(tenant)}.served")

        def record(f):
            if f.cancelled() or f.exception() is not None:
                return
            dt = time.monotonic() - t0
            hist_all.record(dt)
            hist_kind.record(dt)
            served.add()

        fut.add_done_callback(record)
        return fut

    def submit_top_k(self, tenant: str, k: int, *,
                     deadline: float | None = None, cost: float = 1.0):
        return self._submit(tenant, "top_k", k, deadline, cost)

    def submit_sigma(self, tenant: str, seed_set, *,
                     deadline: float | None = None, cost: float = 1.0):
        return self._submit(tenant, "sigma", seed_set, deadline, cost)

    def submit_marginal(self, tenant: str, exclude, *,
                        deadline: float | None = None, cost: float = 1.0):
        return self._submit(tenant, "marginal", exclude, deadline, cost)

    def gather(self, futures, timeout: float | None = None) -> list:
        """Epoch-consistent results (`router.EpochMixError` on a mix)."""
        return self.group.gather(futures, timeout)

    # ----------------------------------------------------- streaming deltas
    def apply_delta(self, tenant: str, delta, *, cost: float = 1.0):
        """Admission-gated streaming graph update — the write front door.

        Charges the tenant's token bucket like any query (`quota.ShedError`
        propagates — a tenant can't starve the pool with delta spam), then
        sweeps the delta across every replica (`ReplicaGroup.apply_delta`:
        one shared dirty-set plan, per-replica atomic swap, graph-epoch
        version bump).  Returns the `repro_torch.stream.StreamReport`; counters
        and histograms land under ``stream.*`` in `snapshot()`.
        """
        from repro_torch.stream import DirtySlotTracker

        self.admission.admit(tenant, cost)      # ShedError propagates
        if self._tracker is None:
            self._tracker = DirtySlotTracker.for_store(
                self.group.replicas[0].store)
        report = self.group.apply_delta(delta, self._tracker)
        self._last_stream = report
        m = self.metrics
        m.counter("stream.deltas_applied").add()
        m.counter("stream.edges_inserted").add(report.inserted)
        m.counter("stream.edges_deleted").add(report.deleted)
        m.counter("stream.slots_resampled").add(report.dirty_slots)
        m.hist("stream.dirty_fraction").record(report.dirty_fraction)
        m.hist("stream.refresh_s").record(report.refresh_s)
        m.counter(f"tenant.{metrics_lib.escape_label(tenant)}.served").add()
        return report

    def maybe_compact(self, threshold: float = 0.10) -> bool:
        """Tombstone-compaction policy: when the forward graph's tombstone
        fraction exceeds ``threshold``, sweep a `ReplicaGroup.compact`
        rebuild (every slot resampled, replicas re-converge
        bit-identically on the renumbered edge ids) and count it under
        ``stream.compactions``.  Returns whether a compaction ran.

        This is the knob the id-stable delta policy needs: interior
        tombstones are individually cheap but accumulate without bound;
        the background loop (``start_background(compact_every=...)``)
        polls this instead of compacting on a timer, so a read-heavy tier
        with little churn never pays the rebuild.
        """
        from repro_torch.stream import compact as compact_lib

        frac = compact_lib.tombstone_fraction(
            self.group.replicas[0].store.graph)
        if frac <= threshold:
            return False
        self.group.compact()
        self.metrics.counter("stream.compactions").add()
        self.metrics.hist("stream.compacted_fraction").record(frac)
        return True

    # ------------------------------------------------------- observability
    def snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        tenants = snap.get("tenant", {})
        admitted = sum(t.get("admitted", 0) for t in tenants.values())
        shed = sum(t.get("shed", 0) for t in tenants.values())
        snap["totals"] = {
            "admitted": admitted, "shed": shed,
            "shed_rate": shed / (admitted + shed) if admitted + shed else 0.0,
        }
        snap["replicas"] = [{
            "index": r.index,
            "pending": r.pending,
            "version": list(r.version),
            "batches": len(r.store.batches),
            "dispatches": r.frontend.batcher.dispatches,
            "flushes": r.frontend.stats.flushes,
            "cache": r.frontend.batcher.cache.stats()
            if r.frontend.batcher.cache is not None else None,
        } for r in self.group.replicas]
        snap["consistent"] = self.group.consistent()
        if self._tracker is not None:
            # Counter/hist snapshots already nest under "stream" (dotted
            # names); graft the tracker's memory/coverage stats alongside.
            snap.setdefault("stream", {})["tracker"] = self._tracker.stats()
        if self.autoscaler is not None and self.autoscaler.decisions:
            snap["autoscale_last"] = dataclasses.asdict(
                self.autoscaler.decisions[-1])
        return snap

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.snapshot(), **dump_kw)

    # ---------------------------------------------------------- lifecycle
    def start_background(self, *, refresh_every: float | None = None,
                         refresh_fraction: float = 0.25,
                         autoscale_every: float | None = None,
                         compact_every: float | None = None,
                         compact_threshold: float = 0.10) -> None:
        """Arm the background loops: replica-sweep refresh, autoscaling,
        and the tombstone-compaction poll (`maybe_compact` every
        ``compact_every`` seconds against ``compact_threshold``)."""
        if refresh_every is not None:
            self.group.start_refresh(refresh_every, refresh_fraction)
        if autoscale_every is not None:
            if self.autoscaler is None:
                raise RuntimeError("tier built without autoscale config")
            self.autoscaler.start(autoscale_every)
        if compact_every is not None:
            if self._compactor is not None:
                raise RuntimeError("compaction thread already running")

            def loop():
                while not self._compact_stop.wait(compact_every):
                    self.maybe_compact(compact_threshold)

            self._compactor = threading.Thread(target=loop, daemon=True,
                                               name="tier-compact")
            self._compactor.start()

    def close(self, timeout: float | None = None) -> None:
        self._compact_stop.set()
        if self._compactor is not None:
            self._compactor.join(timeout)
            self._compactor = None
        if self.autoscaler is not None:
            self.autoscaler.close(timeout)
        self.group.close(timeout)

    def __enter__(self) -> "ServingTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
