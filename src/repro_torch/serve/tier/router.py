"""Replica routing: fan read traffic over N engines serving ONE pool
(PyTorch port of ``repro.serve.tier.router``).

A `Replica` bundles a sketch store, a query engine, a `MicroBatcher` (+
its epoch-keyed cache) and a deadline-batched `AsyncFrontEnd`.  A
`ReplicaGroup` holds N of them built from **clones of the same pool**
(`SketchStore.clone` — shared immutable batches, zero resampling) and
routes each submit to one replica:

* **least_pending** (default) — the replica with the fewest unresolved
  queries, so a slow flush on one replica never queues the others;
* **round_robin** — strict rotation, useful for benchmarking.

**Epoch consistency.**  Every answer is stamped with the pool ``version``
of the flush that computed it (`AsyncFrontEnd` sets ``fut.pool_version``
inside the dispatch lock).  `gather()` is the guard: it refuses to hand
back a set of replies spanning more than one pool version
(`EpochMixError`), so a caller composing multi-query results (a σ
comparison, a marginal-gain sweep) can never silently mix estimates from
different sample populations.

**Replica refresh.**  `refresh()` sweeps the replicas one at a time, each
swap atomic per replica (`AsyncFrontEnd.mutate_store` — the same lock
every flush holds).  Because each clone continues the same
``next_batch_index`` trajectory from the same master seed, the same
refresh applied to every replica resamples the same slots with the same
RNG streams: after the sweep all replicas are **bit-identical again at
the new epoch**.  Mid-sweep, replicas disagree only on version — which
`gather()` turns into a retriable error instead of a wrong answer.
Sweeps are mutually exclusive: `refresh()` and `scale_to()` hold a
group-wide mutation lock for the whole sweep, so every replica sees the
same mutation sequence in the same order even with the background
refresh and autoscale threads both running.  `start_refresh(every)` runs
the sweep on a background thread.
"""
from __future__ import annotations

import itertools
import threading
import time

from repro_torch.serve.distributed.frontend import AsyncFrontEnd
from repro_torch.serve.influence import MicroBatcher, ResultCache
from repro_torch.serve.influence.engine import QueryEngine


class EpochMixError(RuntimeError):
    """A reply set spans more than one pool version; retry the request.

    Raised by `ReplicaGroup.gather` instead of returning estimates drawn
    from different sample populations.  ``versions`` lists the distinct
    pool versions observed.
    """

    def __init__(self, versions):
        super().__init__(f"replies span pool versions {sorted(versions)} — "
                         "a refresh landed mid-request; retry")
        self.versions = tuple(sorted(versions))


class Replica:
    """One engine replica: store + engine + batcher + async front-end."""

    def __init__(self, index: int, store, engine, frontend: AsyncFrontEnd):
        self.index = index
        self.store = store
        self.engine = engine
        self.frontend = frontend

    @classmethod
    def build(cls, index: int, store, *, engine_factory=QueryEngine,
              cache_capacity: int = 4096, **frontend_kw) -> "Replica":
        engine = engine_factory(store)
        batcher = MicroBatcher(engine, cache=ResultCache(cache_capacity))
        return cls(index, store, engine,
                   AsyncFrontEnd(batcher, **frontend_kw))

    @property
    def pending(self) -> int:
        return self.frontend.inflight

    @property
    def version(self):
        return self.store.version

    def close(self, timeout: float | None = None) -> None:
        self.frontend.close(timeout)


class ReplicaGroup:
    """N replicas of one epoch-tagged pool behind a pick policy."""

    POLICIES = ("least_pending", "round_robin")

    def __init__(self, replicas: list[Replica], *,
                 policy: str = "least_pending", metrics=None):
        if not replicas:
            raise ValueError("ReplicaGroup needs at least one replica")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"pick one of {self.POLICIES}")
        self.replicas = list(replicas)
        self.policy = policy
        self._metrics = metrics
        self._rr = itertools.count()
        # Serializes group-wide mutation sweeps (refresh / scale_to).  Per-
        # replica atomicity (mutate_store) is NOT enough: if the background
        # refresh sweep and the autoscaler's scale sweep interleaved,
        # replica 0 could apply refresh-then-ensure while replica 1 applied
        # ensure-then-refresh — each order consumes batch indices (RNG
        # streams) into different slots, so the replicas would permanently
        # diverge while still agreeing on (epoch, count) and consistent()
        # could not tell.  Holding this lock for the FULL sweep guarantees
        # every replica applies the same mutation sequence in the same
        # order.
        self._mutate_lock = threading.Lock()
        self._refresher: threading.Thread | None = None
        self._stop = threading.Event()

    @classmethod
    def build(cls, store, num_replicas: int, *, engine_factory=QueryEngine,
              policy: str = "least_pending", metrics=None,
              **frontend_kw) -> "ReplicaGroup":
        """Replicate ``store`` (clone — no resampling) behind a group."""
        replicas = [
            Replica.build(i, store if i == 0 else store.clone(),
                          engine_factory=engine_factory, **frontend_kw)
            for i in range(num_replicas)]
        return cls(replicas, policy=policy, metrics=metrics)

    # --------------------------------------------------------------- pick
    def pick(self) -> Replica:
        if self.policy == "round_robin" or len(self.replicas) == 1:
            return self.replicas[next(self._rr) % len(self.replicas)]
        return min(self.replicas, key=lambda r: (r.pending, r.index))

    def _submit(self, kind: str, payload, deadline):
        r = self.pick()
        fut = getattr(r.frontend, f"submit_{kind}")(payload,
                                                    deadline=deadline)
        fut.replica_index = r.index
        if self._metrics is not None:
            self._metrics.counter(f"router.replica{r.index}.dispatched").add()
        return fut

    def submit_top_k(self, k: int, *, deadline: float | None = None):
        return self._submit("top_k", k, deadline)

    def submit_sigma(self, seed_set, *, deadline: float | None = None):
        return self._submit("sigma", seed_set, deadline)

    def submit_marginal(self, exclude, *, deadline: float | None = None):
        return self._submit("marginal", exclude, deadline)

    # ------------------------------------------------------------- gather
    @staticmethod
    def gather(futures, timeout: float | None = None) -> list:
        """Results of ``futures``, refusing mixed-epoch reply sets.

        Waits for every future, re-raises the first failure, and checks all
        replies carry the SAME pool version — else `EpochMixError` (the
        caller retries; by then the refresh sweep has converged).  Single
        replies can't mix and pass trivially.  ``timeout`` bounds the WHOLE
        gather (one deadline shared across the futures), not each future.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        values = [f.result(None if deadline is None
                           else deadline - time.monotonic())
                  for f in futures]
        versions = {f.pool_version for f in futures}
        if len(versions) > 1:
            raise EpochMixError(versions)
        return values

    # ------------------------------------------------- epoch-swap refresh
    def refresh(self, fraction: float = 0.25) -> list[int]:
        """Refresh every replica (atomic per replica, identical streams);
        returns the resampled slots (same on every replica).  The whole
        sweep holds the group mutation lock so it can never interleave
        with `scale_to` (see ``_mutate_lock``)."""
        slots: list[int] = []
        with self._mutate_lock:
            for r in self.replicas:
                slots = r.frontend.refresh_now(fraction)
        return slots

    def scale_to(self, num_batches: int) -> None:
        """Grow/shrink every replica's pool to ``num_batches`` slots, each
        swap atomic per replica and the whole sweep exclusive with
        `refresh` (group mutation lock).  Same mutation + same stream
        trajectory ⇒ replicas stay bit-identical at the new size."""
        with self._mutate_lock:
            for r in self.replicas:
                r.frontend.mutate_store(
                    lambda store: (store.ensure(num_batches),
                                   store.shrink(num_batches)))

    def apply_delta(self, delta, tracker):
        """Apply a streaming graph delta to EVERY replica: one shared
        plan (replicas are bit-identical, so one dirty set serves all),
        then a per-replica atomic swap + dirty-slot resample through
        `AsyncFrontEnd.mutate_store` — the same lock every flush holds,
        so an in-flight query is answered entirely pre- or post-delta
        and stamped with the matching graph-epoch version.

        The whole plan+sweep holds the group mutation lock: a refresh or
        scale sweep can neither interleave (which would let replicas see
        delta/refresh in different orders and permanently diverge) nor
        run against a stale plan.  Returns the `stream.StreamReport`, its
        rebind and resample seconds summed over the replicas (the first
        replica's rebind builds a tile backend's layouts for the new pair;
        the others find them in the pair's cache).
        """
        from repro_torch.stream import refresh as stream_refresh

        with self._mutate_lock:
            store0 = self.replicas[0].store
            plan = stream_refresh.plan_refresh(store0, tracker, delta)
            t0 = time.perf_counter()
            spans = [r.frontend.mutate_store(
                lambda store: stream_refresh.apply_plan(store, plan))
                for r in self.replicas]
            refresh_s = time.perf_counter() - t0
            tracker.sync(store0)
            tracker.note_delta(len(plan.dirty_slots))
        return stream_refresh.report_of(
            plan, refresh_s, store0.graph_epoch,
            sum(s[0] for s in spans), sum(s[1] for s in spans))

    def compact(self) -> float:
        """Tombstone-compaction rebuild swept over every replica; returns
        the tombstone fraction that was reclaimed.

        ONE shared rebuilt pair (`stream.compact_graph`) serves the whole
        group — each replica swaps it in and resamples EVERY slot at its
        recorded batch indices, so the group re-converges bit-identical
        on the renumbered edge ids.  Holds the group mutation lock for
        the whole sweep, exclusive with refresh / scale / delta sweeps.
        """
        from repro_torch.stream import compact as compact_lib

        with self._mutate_lock:
            store0 = self.replicas[0].store
            frac = compact_lib.tombstone_fraction(store0.graph)
            g2, g_rev2 = compact_lib.compact_graph(store0.graph)

            def swap(store):
                store.apply_graph_update(g2, g_rev2)
                store.resample_slots(list(range(len(store.batches))))

            for r in self.replicas:
                r.frontend.mutate_store(swap)
        return frac

    def start_refresh(self, every: float, fraction: float = 0.25) -> None:
        """Background replica-refresh sweep every ``every`` seconds."""
        if self._refresher is not None:
            raise RuntimeError("refresh thread already running")

        def loop():
            while not self._stop.wait(every):
                self.refresh(fraction)

        self._refresher = threading.Thread(target=loop, daemon=True,
                                           name="tier-refresh")
        self._refresher.start()

    # ---------------------------------------------------------- lifecycle
    @property
    def num_batches(self) -> int:
        return len(self.replicas[0].store.batches)

    def versions(self) -> list:
        return [r.version for r in self.replicas]

    def consistent(self) -> bool:
        """True when every replica serves the same pool version."""
        return len(set(self.versions())) == 1

    def pending(self) -> list[int]:
        return [r.pending for r in self.replicas]

    def close(self, timeout: float | None = None) -> None:
        self._stop.set()
        if self._refresher is not None:
            self._refresher.join(timeout)
            self._refresher = None
        for r in self.replicas:
            r.close(timeout)

    def __enter__(self) -> "ReplicaGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
