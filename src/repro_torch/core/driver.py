"""Fault-tolerant fused-BPT sampling driver (paper §5 heterogeneous work
queue, made deterministic).

The paper's Ripples uses a host-side atomic counter that CPU/GPU workers
decrement to claim BPT batches.  Our batches are *idempotent* — batch ``b``
is a pure function of ``(graph, master_seed, b)`` (core/rrr.py) — so the
same queue becomes fault-tolerant for free:

* **node failure**  → the claimed batch times out and is reissued; the
  replacement reproduces bit-identical RRR sets.
* **stragglers**    → when the queue drains, outstanding batches are
  *speculatively* reissued to idle workers (MapReduce backup tasks);
  first completion wins, and idempotence makes the race benign.
* **elastic scale** → workers are stateless; the pool can grow/shrink
  between rounds without touching sampling state.

``failure_rate`` / ``slow_rate`` inject deterministic faults for tests.

PyTorch port of ``repro.core.driver``.  The workers share one sampler on
the graph's device.  A sample keeps no scratch on the sampler or in the
kernel wrappers (each launch allocates its own output on the current
stream; the tile sampler's ``last_*`` diagnostics are last-writer-wins),
so concurrent and duplicate calls are race-free.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

from repro_torch.core import rrr
from repro_torch.graph import csr


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class DriverStats:
    completed: int = 0
    failures: int = 0
    reissues: int = 0
    speculative: int = 0


class SamplingDriver:
    def __init__(self, g_rev: csr.Graph, num_colors: int, master_seed: int,
                 *, num_workers: int = 4, timeout_s: float = 120.0,
                 max_attempts: int = 5, failure_rate: float = 0.0,
                 slow_rate: float = 0.0, slow_s: float = 0.3,
                 spec=None):
        from repro_torch import sampling

        self.g_rev = g_rev
        self.num_colors = num_colors
        self.master_seed = master_seed
        self.num_workers = num_workers
        self.timeout_s = timeout_s
        self.max_attempts = max_attempts
        self.failure_rate = failure_rate
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        # Shared reconciliation policy: the driver's num_colors/master_seed
        # are required args, hence always explicit — a disagreeing spec
        # raises rather than silently overriding.
        self.spec = sampling.resolve_spec(spec, num_colors=num_colors,
                                          master_seed=master_seed)
        if self.spec.backend in ("data_parallel", "graph_parallel"):
            raise ValueError(
                "SamplingDriver parallelizes across worker threads, not a "
                "mesh — use a dense/tiled/kernel spec here")
        # Workers are threads sharing one stateless sampler: sampling is a
        # pure function of (graph, master_seed, batch_index), so concurrent
        # (and speculative duplicate) calls are race-free by construction.
        self.sampler = sampling.make_sampler(None, self.spec, g_rev=g_rev)
        self.stats = DriverStats()
        self._lock = threading.Lock()

    def _inject(self, batch_index: int, attempt: int):
        """Deterministic fault injection keyed by (batch, attempt)."""
        h = ((batch_index * 2654435761 + attempt * 40503)
             * 2246822519) & 0xFFFFFFFF
        u = (h % (1 << 24)) / (1 << 24)
        if u < self.failure_rate:
            with self._lock:
                self.stats.failures += 1
            raise InjectedFailure(f"batch {batch_index} attempt {attempt}")
        if u < self.failure_rate + self.slow_rate:
            time.sleep(self.slow_s)                    # straggler

    def _work(self, batch_index: int, attempt: int) -> rrr.RRRBatch:
        self._inject(batch_index, attempt)
        return self.sampler.sample(batch_index)

    def run(self, n_batches: int) -> list[rrr.RRRBatch]:
        """Sample ``n_batches`` with reissue-on-failure and speculative
        re-execution of stragglers.  Returns batches ordered by index."""
        results: dict[int, rrr.RRRBatch] = {}
        attempts = {b: 0 for b in range(n_batches)}
        pending = list(range(n_batches))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = {}

            def submit(b):
                attempts[b] += 1
                if attempts[b] > self.max_attempts:
                    raise RuntimeError(f"batch {b} exceeded max attempts")
                fut = pool.submit(self._work, b, attempts[b])
                futures[fut] = b

            for b in pending[: self.num_workers * 2]:
                submit(b)
            queued = set(pending[: self.num_workers * 2])
            backlog = [b for b in pending if b not in queued]

            deadline = time.monotonic() + self.timeout_s
            while len(results) < n_batches:
                if not futures:
                    for b in range(n_batches):      # everything failed: retry
                        if b not in results:
                            submit(b)
                done, _ = wait(list(futures), timeout=self.timeout_s,
                               return_when=FIRST_COMPLETED)
                if not done and time.monotonic() > deadline:
                    # global straggler sweep: reissue everything outstanding
                    for fut, b in list(futures.items()):
                        if b not in results:
                            self.stats.reissues += 1
                            submit(b)
                    deadline = time.monotonic() + self.timeout_s
                    continue
                for fut in done:
                    b = futures.pop(fut)
                    try:
                        res = fut.result()
                    except InjectedFailure:
                        if b not in results:
                            self.stats.reissues += 1
                            submit(b)
                        continue
                    if b not in results:
                        results[b] = res
                        with self._lock:
                            self.stats.completed += 1
                    if backlog:
                        nxt = backlog.pop(0)
                        submit(nxt)
                # speculative re-execution: idle capacity + outstanding work
                outstanding = [b for b in set(futures.values())
                               if b not in results]
                idle = self.num_workers - len(futures)
                for b in outstanding[: max(idle, 0)]:
                    self.stats.speculative += 1
                    submit(b)
        return [results[b] for b in range(n_batches)]
