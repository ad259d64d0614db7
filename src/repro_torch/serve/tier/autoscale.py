"""Signal-driven sketch-pool autoscaling (PyTorch port of
``repro.serve.tier.autoscale``).

The pool slot count is the serving tier's one capacity knob: more slots →
tighter coverage-error bound (θ = slots × colors samples) but a heavier
per-query popcount sweep (every σ/marginal/top-k scans all B slots).  The
`AutoScaler` closes the loop from two *measured* signals:

* **coverage error** — `core.imm.eps_bound_for_theta`, the exact inverse
  of ``estimate_theta``'s λ*/LB sample bound: the smallest IMM ε the
  current θ certifies, with OPT lower-bounded by the greedy σ̂ the pool
  itself serves (refreshed each step, it tracks pool drift for free);
* **query latency** — the tier's p99 from its `metrics.Histogram`
  (an SLO target in milliseconds).

Policy (evaluated by ``step()``, applied via `ReplicaGroup.scale_to` →
`AsyncFrontEnd.mutate_store` → ``SketchStore.ensure``/``shrink``, so every
scale event is an atomic per-replica epoch swap that extends or slices the
existing pool allocation — **never** a cold rebuild):

1. ε bound above ``target_eps`` → **grow** to the slot count whose θ meets
   the target (accuracy beats latency: an out-of-bound estimator is wrong,
   a slow one is late).
2. Otherwise, p99 above ``target_p99_ms`` AND the pool has ε headroom
   (shedding one ``shrink_step`` keeps ε ≤ ``headroom`` × target) →
   **shrink** one step.
3. Otherwise **hold**.

Decisions are clamped to [``min_batches``, ``max_batches``] and returned
as an `AutoScaleDecision` record so launchers/benchmarks can log the whole
control trajectory.  ``start(every)`` runs ``step()`` on a background
thread.
"""
from __future__ import annotations

import dataclasses
import math
import threading

from repro_torch.core import imm


@dataclasses.dataclass(frozen=True)
class AutoScaleDecision:
    action: str                 # "grow" | "shrink" | "hold"
    batches_before: int
    batches_after: int
    reason: str
    eps_bound: float
    p99_ms: float | None
    theta: int


class AutoScaler:
    """Grow/shrink a `ReplicaGroup`'s pool from measured signals."""

    def __init__(self, group, *, k: int = 8, target_eps: float = 0.3,
                 target_p99_ms: float | None = None,
                 latency_hist=None, ell: float = 1.0,
                 headroom: float = 1.3, shrink_step: int = 1,
                 min_batches: int = 1, max_batches: int | None = None,
                 metrics=None):
        self.group = group
        self.k = k
        self.target_eps = target_eps
        self.target_p99_ms = target_p99_ms
        self.latency_hist = latency_hist
        self.ell = ell
        self.headroom = headroom
        self.shrink_step = shrink_step
        self.min_batches = min_batches
        store = group.replicas[0].store
        self.max_batches = (max_batches if max_batches is not None
                            else store.capacity)
        self._metrics = metrics
        self._opt_lb = 1.0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.decisions: list[AutoScaleDecision] = []

    # ------------------------------------------------------------ signals
    @property
    def _store(self):
        return self.group.replicas[0].store

    def _refresh_opt_lb(self) -> float:
        """OPT ≥ σ̂(greedy seeds): one top-k through a replica's own
        front-end (so it serializes with dispatch and rides the cache)."""
        fut = self.group.submit_top_k(self.k, deadline=0.0)
        _, sigma_hat = fut.result(timeout=600)
        self._opt_lb = max(self._opt_lb, float(sigma_hat))
        return self._opt_lb

    def eps_bound(self, theta: int | None = None) -> float:
        store = self._store
        return imm.eps_bound_for_theta(
            store.graph.num_vertices, self.k,
            theta if theta is not None else store.num_samples,
            ell=self.ell, opt_lb=self._opt_lb)

    def _batches_for_eps(self, eps: float) -> int:
        """Smallest slot count whose θ certifies ``eps`` (λ* ∝ 1/ε²)."""
        store = self._store
        coeff = imm.eps_bound_for_theta(store.graph.num_vertices, self.k, 1,
                                        ell=self.ell, opt_lb=self._opt_lb)
        theta_needed = (coeff / eps) ** 2
        return max(1, math.ceil(theta_needed / store.num_colors))

    def p99_ms(self) -> float | None:
        if self.latency_hist is None or self.latency_hist.count == 0:
            return None
        return self.latency_hist.quantile(0.99) * 1e3

    # --------------------------------------------------------------- step
    def step(self) -> AutoScaleDecision:
        """Evaluate the signals once; apply and record the decision."""
        self._refresh_opt_lb()
        before = self.group.num_batches
        eps_now = self.eps_bound()
        p99 = self.p99_ms()
        target, action, reason = before, "hold", "within targets"

        if eps_now > self.target_eps:
            want = min(self._batches_for_eps(self.target_eps),
                       self.max_batches)
            if want > before:
                action, target = "grow", want
                reason = (f"eps bound {eps_now:.3f} > target "
                          f"{self.target_eps:.3f}")
            else:
                reason = (f"eps bound {eps_now:.3f} over target but pool "
                          f"at max_batches={self.max_batches}")
        elif (self.target_p99_ms is not None and p99 is not None
              and p99 > self.target_p99_ms):
            shrunk = max(self.min_batches, before - self.shrink_step)
            eps_shrunk = self.eps_bound(shrunk * self._store.num_colors)
            if shrunk < before and \
                    eps_shrunk <= self.headroom * self.target_eps:
                action, target = "shrink", shrunk
                reason = (f"p99 {p99:.1f}ms > target {self.target_p99_ms}ms "
                          f"with eps headroom ({eps_shrunk:.3f} ≤ "
                          f"{self.headroom:.2f}×{self.target_eps:.3f})")
            else:
                reason = (f"p99 {p99:.1f}ms over target but no eps headroom "
                          "to shrink")

        if action != "hold":
            self.group.scale_to(target)
        after = self.group.num_batches
        decision = AutoScaleDecision(action, before, after, reason,
                                     round(eps_now, 4), p99,
                                     self._store.num_samples)
        self.decisions.append(decision)
        if self._metrics is not None:
            self._metrics.counter(f"autoscale.{action}").add()
        return decision

    # ---------------------------------------------------------- lifecycle
    def start(self, every: float) -> None:
        if self._thread is not None:
            raise RuntimeError("autoscaler already running")

        def loop():
            while not self._stop.wait(every):
                self.step()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="tier-autoscale")
        self._thread.start()

    def close(self, timeout: float | None = None) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
