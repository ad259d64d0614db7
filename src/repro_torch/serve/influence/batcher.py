"""Micro-batcher: many concurrent callers, one device dispatch per kind
(port of ``repro.serve.influence.batcher``; plain Python, unchanged in
behaviour).

Callers ``submit_*`` queries and later ``flush()``; the batcher resolves
cache hits host-side, packs the remaining σ(S)/marginal queries into the
engine's fixed ``(query_slots, max_seeds)`` tensors (chunking when a flush
overflows the slots), runs one dispatch per query kind, and fans results
back out by ticket.

**Thread safety.**  Submits and flushes may come from any thread: ticket
allocation, the pending list, the dispatch counter, and every result-cache
access are guarded by one internal lock.  ``flush()`` swaps the pending
list out under the lock and runs the device dispatches *outside* it, so
callers keep submitting (into the next batch) while a flush is on device.
The ``ResultCache`` carries its own lock and an atomic ``stats()``
snapshot, so observers (e.g. the serving tier's metrics exporter) may read
it concurrently; *writes* still route through the owning batcher.

**Deadlines.**  ``submit_*(..., deadline=s)`` tags the request "dispatch
within ``s`` seconds"; the batcher never flushes by itself, but exposes
``oldest_deadline()`` / ``pending_count`` so a driver
(`repro_torch.serve.distributed.frontend.AsyncFrontEnd`) can flush on
*full slot or oldest deadline, whichever first*.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

from repro_torch.serve.influence import cache as cache_lib

TOP_K, SIGMA, MARGINAL = "top_k", "sigma", "marginal"


@dataclasses.dataclass(frozen=True)
class _Pending:
    ticket: int
    kind: str
    key: tuple          # canonical cache key
    seeds: tuple        # seed / exclusion set as submitted (deduped, sorted)
    deadline: float | None = None   # absolute time.monotonic() dispatch-by


class FlushError(RuntimeError):
    """A device dispatch failed mid-flush.

    ``tickets`` lists only the tickets left *unanswered* — queries resolved
    before the failure (cache hits, earlier successful dispatch kinds in
    the same flush) sit in ``partial`` and should be delivered normally.
    Tickets submitted after the flush swapped its pending set are in
    neither: they are still queued for the next flush.
    """

    def __init__(self, tickets, partial: dict, cause: BaseException):
        super().__init__(f"influence-query flush failed: {cause!r}")
        self.tickets = tuple(tickets)
        self.partial = partial
        self.__cause__ = cause


class MicroBatcher:
    """Pads concurrent influence queries into slotted batch dispatches."""

    def __init__(self, engine, cache: cache_lib.ResultCache | None = None):
        self.engine = engine
        self.cache = cache
        self._lock = threading.RLock()
        self._pending: list[_Pending] = []
        self._next_ticket = 0
        self.dispatches = 0         # device dispatches issued (observability)

    # ------------------------------------------------------------- submit
    def _submit(self, kind: str, key: tuple, seeds: tuple,
                deadline: float | None) -> int:
        dl = None if deadline is None else time.monotonic() + deadline
        with self._lock:
            t = self._next_ticket
            self._next_ticket += 1
            self._pending.append(_Pending(t, kind, key, seeds, dl))
        return t

    def submit_top_k(self, k: int, *, deadline: float | None = None) -> int:
        return self._submit(TOP_K, (int(k),), (int(k),), deadline)

    def _checked_key(self, seeds) -> tuple:
        """Canonicalize + validate at submit time: an oversized seed set
        must fail on the offending caller, never abort a shared flush."""
        key = cache_lib.seed_key(seeds)
        if len(key) > self.engine.max_seeds:
            raise ValueError(f"seed set of {len(key)} > "
                             f"max_seeds={self.engine.max_seeds}")
        return key

    def submit_sigma(self, seed_set, *, deadline: float | None = None) -> int:
        key = self._checked_key(seed_set)
        return self._submit(SIGMA, key, key, deadline)

    def submit_marginal(self, exclude, *,
                        deadline: float | None = None) -> int:
        key = self._checked_key(exclude)
        return self._submit(MARGINAL, key, key, deadline)

    # -------------------------------------------------------- observation
    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_deadline(self) -> float | None:
        """Earliest absolute dispatch-by time among pending queries (None
        when nothing pending carries a deadline)."""
        with self._lock:
            dls = [p.deadline for p in self._pending if p.deadline is not None]
        return min(dls) if dls else None

    # -------------------------------------------------------------- flush
    def _lookup(self, p: _Pending, version):
        if self.cache is None:
            return None
        return self.cache.get(version, p.kind, p.key)

    def _store(self, p: _Pending, value, version) -> None:
        if self.cache is not None:
            self.cache.put(version, p.kind, p.key, value)

    def flush(self) -> dict[int, Any]:
        """Answer every pending query; returns {ticket: result}.

        Results: top-k → (seeds, σ estimate); sigma → float; marginal →
        (V,) gain vector.  Identical queries in one flush share a slot.
        Device dispatches run outside the lock; submits landing during a
        flush join the *next* one.

        A dispatch failure raises `FlushError` carrying the results already
        computed (``partial``) and naming exactly the still-unanswered
        tickets; later submits are untouched and stay pending.  A driver
        delivers the partials and fails precisely the named callers.
        """
        with self._lock:
            pending, self._pending = self._pending, []
            # Snapshot the pool version with the batch: results are tagged
            # with the version they were *requested* under, so a refresh
            # landing mid-dispatch can only make these entries stale
            # (miss + recompute later), never poison the cache with an
            # old answer filed under the new version.
            version = self.engine.store.version
        results: dict[int, Any] = {}
        try:
            self._flush(pending, results, version)
        except Exception as e:              # noqa: BLE001 — annotate + rethrow
            unanswered = [p.ticket for p in pending
                          if p.ticket not in results]
            raise FlushError(unanswered, results, e) from e
        return results

    def _flush(self, pending: list[_Pending], results: dict[int, Any],
               version) -> None:
        todo: dict[str, dict[tuple, list[_Pending]]] = {}
        with self._lock:
            for p in pending:
                hit = self._lookup(p, version)
                if hit is not None:
                    results[p.ticket] = hit
                else:
                    todo.setdefault(p.kind, {}).setdefault(p.key, []).append(p)

        for key, ps in todo.get(TOP_K, {}).items():
            value = self.engine.top_k(key[0])
            with self._lock:
                self.dispatches += 1
                self._store(ps[0], value, version)
                for p in ps:
                    results[p.ticket] = value

        for kind, run in ((SIGMA, self._run_sigma),
                          (MARGINAL, self._run_marginal)):
            groups = list(todo.get(kind, {}).items())
            slots = self.engine.query_slots
            for i in range(0, len(groups), slots):
                chunk = groups[i:i + slots]
                values = run([ps[0].seeds for _, ps in chunk])
                with self._lock:
                    self.dispatches += 1
                    for (key, ps), value in zip(chunk, values):
                        self._store(ps[0], value, version)
                        for p in ps:
                            results[p.ticket] = value

    def _run_sigma(self, seed_sets):
        return list(self.engine.sigma(seed_sets))

    def _run_marginal(self, excl_sets):
        gains = self.engine.marginal_padded(*self.engine.pad(excl_sets))
        return [gains[q] for q in range(len(excl_sets))]
