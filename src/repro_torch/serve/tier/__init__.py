"""Production serving tier: quotas → replicas → autoscaling → SLOs
(PyTorch port of ``repro.serve.tier``).

One engine behind one async front end serves a pool; this package is
the layer that makes the sketch pool survive *traffic*:

* `quota.AdmissionController` — per-tenant token buckets in front of
  submit; over-quota requests shed with a retriable `ShedError` carrying
  ``retry_after`` before they can touch an engine;
* `router.ReplicaGroup` — N engine replicas serving clones of the SAME
  epoch-tagged pool (least-pending/round-robin pick), with an epoch
  consistency guard (`EpochMixError`) that refuses to hand back replies
  spanning a mid-stream refresh, and an atomic-per-replica refresh sweep
  that re-converges all replicas bit-identically at the new epoch;
* `autoscale.AutoScaler` — grows/shrinks the pool slot count from
  measured signals (query p99 + the inverse IMM coverage-error bound
  `core.imm.eps_bound_for_theta`) through the in-place
  ensure/shrink paths, never a cold rebuild;
* `metrics.MetricSet` — lock-cheap counters + log-bucket latency
  histograms (p50/p99/p999), snapshot-able as JSON;
* `service.ServingTier` — the front door wiring all of the above.

    store = SketchStore(g, PoolConfig(num_colors=64)); store.ensure(8)
    tier = ServingTier.build(store, replicas=2, quota_qps=50.0,
                             default_deadline=0.02)
    tier.set_quota("free", rate=2.0, burst=2)
    sigma = tier.submit_sigma("alice", [3, 17, 42]).result()

The port has no load benchmark yet; ``chip_smoke.py``'s tier phase reads
the tier's p50/p99 from its own histogram.
"""
from repro_torch.serve.tier.autoscale import AutoScaleDecision, AutoScaler
from repro_torch.serve.tier.metrics import Counter, Histogram, MetricSet
from repro_torch.serve.tier.quota import AdmissionController, ShedError
from repro_torch.serve.tier.router import EpochMixError, Replica, ReplicaGroup
from repro_torch.serve.tier.service import ServingTier

__all__ = ["AdmissionController", "AutoScaleDecision", "AutoScaler",
           "Counter", "EpochMixError", "Histogram", "MetricSet", "Replica",
           "ReplicaGroup", "ServingTier", "ShedError"]
