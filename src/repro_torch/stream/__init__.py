"""Streaming graph updates: id-stable CSR deltas, visited-row-block
dirty tracking, and churn-proportional incremental pool refresh (PyTorch
port of ``repro.stream``).

    from repro_torch import stream

    delta = stream.EdgeDelta.inserts([3], [17], [0.05])
    tracker = stream.DirtySlotTracker.for_store(store)
    report = stream.incremental_refresh(store, tracker, delta)
    # store now serves the mutated graph; only dirty slots resampled,
    # bit-identical to a cold rebuild (masks and work counters).

Layer map: `delta` (EdgeDelta / apply_delta — the id-stable CSR
mutation contract), `dirty` (DirtySlotTracker — slot × row-block
bitsets), `refresh` (plan/apply + the cold-rebuild reference), `compact`
(the periodic tombstone-dropping rebuild that bounds id-stability's
cost).  The serving tier front door is `ServingTier.apply_delta`, with
`ServingTier.maybe_compact` as the compaction policy hook.
"""
from repro_torch.stream.compact import (compact_graph, compact_store,
                                  tombstone_fraction)
from repro_torch.stream.delta import (AppliedDelta, EdgeDelta, apply_delta,
                                random_delta, touched_row_blocks)
from repro_torch.stream.dirty import DirtySlotTracker
from repro_torch.stream.refresh import (DeltaPlan, StreamReport, apply_plan,
                                  cold_rebuild_batches, incremental_refresh,
                                  plan_refresh)

__all__ = [
    "AppliedDelta", "EdgeDelta", "apply_delta", "random_delta",
    "touched_row_blocks", "DirtySlotTracker", "DeltaPlan", "StreamReport",
    "apply_plan", "cold_rebuild_batches", "incremental_refresh",
    "plan_refresh", "compact_graph", "compact_store", "tombstone_fraction",
]
