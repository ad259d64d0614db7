"""Async deadline-batched serving front-end (PyTorch port of
``repro.serve.distributed.frontend``; engine-agnostic host Python).

Callers submit influence queries from any thread and get a
``concurrent.futures.Future``; a single dispatcher thread owns every
device dispatch.  A flush fires on whichever comes first:

* **full slot** — pending queries reach ``flush_slots`` (the engine's
  padded batch is full, dispatching now wastes nothing), or
* **deadline** — the *oldest* pending request's deadline arrives (a lone
  request is dispatched on time instead of waiting for company).

A background refresh worker (enabled with ``refresh_every``) resamples the
stalest ``refresh_fraction`` of the pool between dispatches.  Refresh and
flush serialize on one dispatch lock, and ``SketchStore.refresh`` bumps
the store version inside that critical section — so every flush sees a
consistent (stack, version) pair and the epoch-keyed ``ResultCache`` can
never serve a result computed under another epoch.

The front-end only talks to the batcher, so it serves any engine
(the sharded engine comes with the multi-GPU slice).

    engine  = QueryEngine(store)
    fe = AsyncFrontEnd(MicroBatcher(engine, cache=ResultCache()),
                       default_deadline=0.02, refresh_every=30.0)
    fut = fe.submit_sigma([3, 17, 42])          # any thread
    sigma = fut.result()
    fe.close()
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time

from repro_torch.serve.influence import batcher as batcher_lib


@dataclasses.dataclass
class FrontEndStats:
    """Serving observability counters (read at any time; snapshot under the
    front-end's condition lock)."""
    flushes: int = 0
    slot_flushes: int = 0       # triggered by a full slot
    deadline_flushes: int = 0   # triggered by the oldest request's deadline
    drain_flushes: int = 0      # close() draining the tail
    served: int = 0
    refreshes: int = 0
    max_queue_wait: float = 0.0  # worst submit → dispatch-start wait (s)


class AsyncFrontEnd:
    """Thread-safe request queue + deadline-batched dispatcher thread."""

    def __init__(self, batcher, *, default_deadline: float = 0.05,
                 flush_slots: int | None = None,
                 refresh_every: float | None = None,
                 refresh_fraction: float = 0.25):
        self.batcher = batcher
        self.default_deadline = default_deadline
        self.flush_slots = (flush_slots if flush_slots is not None
                            else batcher.engine.query_slots)
        self.refresh_every = refresh_every
        self.refresh_fraction = refresh_fraction
        self.stats = FrontEndStats()

        self._cv = threading.Condition()
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._submit_times: dict[int, float] = {}
        self._closed = False
        self._stop_event = threading.Event()
        # Serializes device dispatches with pool refreshes: a refresh can
        # never swap sketches out from under an in-flight flush.
        self._dispatch_lock = threading.Lock()

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="frontend-dispatch")
        self._dispatcher.start()
        self._refresher = None
        if refresh_every is not None:
            self._refresher = threading.Thread(
                target=self._refresh_loop, daemon=True,
                name="frontend-refresh")
            self._refresher.start()

    # ------------------------------------------------------------- submit
    def _submit(self, submit_fn, payload,
                deadline: float | None) -> concurrent.futures.Future:
        deadline = self.default_deadline if deadline is None else deadline
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncFrontEnd is closed")
            # Validation (e.g. oversized seed set) raises HERE, on the
            # offending caller's thread — never inside a shared flush.
            ticket = submit_fn(payload, deadline=deadline)
            self._futures[ticket] = fut
            self._submit_times[ticket] = time.monotonic()
            self._cv.notify_all()
        return fut

    def submit_top_k(self, k: int, *,
                     deadline: float | None = None) -> concurrent.futures.Future:
        return self._submit(self.batcher.submit_top_k, k, deadline)

    def submit_sigma(self, seed_set, *,
                     deadline: float | None = None) -> concurrent.futures.Future:
        return self._submit(self.batcher.submit_sigma, seed_set, deadline)

    def submit_marginal(self, exclude, *,
                        deadline: float | None = None) -> concurrent.futures.Future:
        return self._submit(self.batcher.submit_marginal, exclude, deadline)

    @property
    def inflight(self) -> int:
        """Submitted-but-unresolved queries (queued + on device) — the
        load signal a replica router balances on."""
        with self._cv:
            return len(self._futures)

    # --------------------------------------------------------- dispatcher
    def _wait_for_trigger(self) -> str | None:
        """Block until a flush should fire; returns the trigger kind, or
        None when closed and fully drained."""
        with self._cv:
            while True:
                pending = self.batcher.pending_count
                if self._closed:
                    return "drain" if pending else None
                if pending >= self.flush_slots:
                    return "slots"
                deadline = self.batcher.oldest_deadline()
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    return "deadline"
                self._cv.wait(
                    timeout=None if deadline is None else deadline - now)

    def _dispatch_loop(self) -> None:
        while True:
            trigger = self._wait_for_trigger()
            if trigger is None:
                return
            start = time.monotonic()
            try:
                with self._dispatch_lock:
                    # Refreshes serialize on the dispatch lock, so this read
                    # equals the version ``flush`` snapshots internally —
                    # the epoch tag every resolved future is stamped with.
                    version = self.batcher.engine.store.version
                    results = self.batcher.flush()
                failed, error = (), None
            except batcher_lib.FlushError as e:  # fail futures, not the thread
                results, failed, error = e.partial, e.tickets, e
            resolved = []
            attr = {"slots": "slot_flushes", "deadline": "deadline_flushes",
                    "drain": "drain_flushes"}[trigger]
            with self._cv:
                self.stats.flushes += 1
                setattr(self.stats, attr, getattr(self.stats, attr) + 1)
                # Fail exactly the tickets the broken dispatch left
                # unanswered; partial results below are delivered normally,
                # and requests submitted during the flush stay queued.
                for ticket in failed:
                    fut = self._futures.pop(ticket, None)
                    self._submit_times.pop(ticket, None)
                    if fut is not None:
                        resolved.append((fut, None, error))
                for ticket, value in results.items():
                    fut = self._futures.pop(ticket, None)
                    t0 = self._submit_times.pop(ticket, None)
                    if t0 is not None:
                        self.stats.max_queue_wait = max(
                            self.stats.max_queue_wait, start - t0)
                    if fut is not None:
                        resolved.append((fut, value, None))
                        self.stats.served += 1
            # Resolve outside the lock: a future callback may re-submit.
            for fut, value, err in resolved:
                if not fut.set_running_or_notify_cancel():
                    continue        # caller cancelled while queued
                if err is not None:
                    fut.set_exception(err)
                else:
                    # Epoch tag: the pool version this answer was computed
                    # under (the serving tier's replica router refuses to
                    # mix replies across versions).  Set before set_result
                    # so done-callbacks and result() waiters always see it.
                    fut.pool_version = version
                    fut.set_result(value)

    # --------------------------------------------- store mutations/refresh
    def mutate_store(self, fn):
        """Run ``fn(store)`` atomically wrt dispatch and return its result.

        The mutation (refresh, tier autoscale grow/shrink, ...) holds the
        same lock every flush holds, so a version bump + stack swap can
        never land under an in-flight dispatch — each flush sees one
        consistent (stack, version) pair, and every replica-wide mutation
        the serving tier applies is an atomic epoch swap on this replica.
        """
        with self._dispatch_lock:
            result = fn(self.batcher.engine.store)
        with self._cv:
            self._cv.notify_all()
        return result

    def refresh_now(self, fraction: float | None = None) -> list[int]:
        """One epoch refresh, serialized with dispatch; returns the
        resampled slots."""
        frac = self.refresh_fraction if fraction is None else fraction
        slots = self.mutate_store(lambda store: store.refresh(frac))
        with self._cv:
            self.stats.refreshes += 1
        return slots

    def _refresh_loop(self) -> None:
        while not self._stop_event.wait(self.refresh_every):
            with self._dispatch_lock:
                if self._closed:
                    return
                # Atomic wrt dispatch: version bump + stack invalidation
                # happen inside the same critical section the flush uses.
                self.batcher.engine.store.refresh(self.refresh_fraction)
            with self._cv:
                self.stats.refreshes += 1
                self._cv.notify_all()

    # -------------------------------------------------------------- close
    def close(self, timeout: float | None = None) -> None:
        """Stop accepting submits, drain, join workers, resolve stragglers.

        Drain contract: **no submitted future is ever left unresolved.**
        The dispatcher's final iterations flush everything still pending
        (the ``drain`` trigger), delivering answers or — if a drain
        dispatch breaks — failing exactly the consumed tickets with the
        `FlushError`.  If any future somehow remains after the workers are
        joined (dispatcher died on an unexpected error, or ``timeout``
        expired mid-drain), it is failed here with a `FlushError` rather
        than hanging its caller forever.  Idempotent.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._stop_event.set()
        self._dispatcher.join(timeout)
        if self._refresher is not None:
            self._refresher.join(timeout)
        with self._cv:
            leftovers = list(self._futures.items())
            self._futures.clear()
            self._submit_times.clear()
        if leftovers:
            error = batcher_lib.FlushError(
                [t for t, _ in leftovers], {},
                RuntimeError("AsyncFrontEnd closed before the dispatcher "
                             "drained these tickets"))
            for _, fut in leftovers:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(error)

    def __enter__(self) -> "AsyncFrontEnd":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
