"""Churn-proportional incremental pool refresh after a graph delta
(PyTorch port of ``repro.stream.refresh``).

The pipeline (`incremental_refresh`, or `plan_refresh` + `apply_plan`
when one plan must sweep several bit-identical replicas):

1. apply the delta to BOTH graphs of the store's pair — the forward
   graph directly, the reversed graph via ``delta.reversed()`` (never
   `csr.transpose`, which renumbers edge ids), with LT re-normalization
   confined to the mutated destinations when the pool is LT;
2. map the REVERSED graph's touched source rows (traversals run on
   ``g_rev``) to `FrontierIndex` row-blocks and intersect with the
   `DirtySlotTracker` bitsets → the dirty slot set;
3. swap the pair into the store (`SketchStore.apply_graph_update` —
   sampler rebuilt, graph epoch bumped so `version` changes) and
   resample ONLY the dirty slots at their recorded batch indices
   (`resample_slots` — an in-place write of the stack's slots, no
   epoch bump, no new RNG streams).

Because slot ``i`` is a pure function of ``(graph, master_seed,
batch_index_i)`` and clean slots provably reproduce on the new graph
(`dirty` module doc), the refreshed pool is bit-identical — masks and
work counters — to a cold rebuild of the same batch indices on the
mutated graph, at a cost proportional to the dirty fraction instead of
the pool (and graph) size.  `cold_rebuild_batches` computes that cold
reference; smokes, CI, and the bench assert the identity.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import device as device_lib
from repro_torch.stream import delta as delta_lib
from repro_torch.stream.dirty import DirtySlotTracker

__all__ = ["DeltaPlan", "StreamReport", "plan_refresh", "apply_plan",
           "incremental_refresh", "cold_rebuild_batches", "report_of"]


@dataclasses.dataclass(frozen=True)
class DeltaPlan:
    """Everything `apply_plan` needs, computed once per delta.

    A replica group computes ONE plan (replicas are bit-identical, so the
    dirty set is shared) and applies it to every replica's store.
    """
    g: object                    # mutated forward Graph
    g_rev: object                # mutated reversed Graph (delta.reversed())
    applied: delta_lib.AppliedDelta      # forward-graph op counts
    touched_row_blocks: np.ndarray       # reversed-graph blocks, sorted
    dirty_slots: list[int]
    total_slots: int

    @property
    def dirty_fraction(self) -> float:
        return len(self.dirty_slots) / max(self.total_slots, 1)


@dataclasses.dataclass(frozen=True)
class StreamReport:
    """What one applied delta did — the tier's metrics payload.
    ``refresh_s`` is the host-clock span of applying the plan to every
    store; ``rebind_s`` and ``resample_s`` split it into the samplers'
    rebinding (a tile backend's layout and slot-list rebuild) and the
    dirty slots' resampling, summed over the stores."""
    inserted: int
    deleted: int
    touched_row_blocks: int
    dirty_slots: int
    total_slots: int
    dirty_fraction: float
    refresh_s: float
    graph_epoch: int
    rebind_s: float = 0.0
    resample_s: float = 0.0


def plan_refresh(store, tracker: DirtySlotTracker,
                 delta: delta_lib.EdgeDelta) -> DeltaPlan:
    """Dirty-set planning: mutate the graph pair (functionally) and
    intersect the reversed-graph touched rows with the tracker bitsets.
    The store itself is not modified."""
    tracker.sync(store)
    lt = store.spec.diffusion == "lt"
    g, applied_fwd = delta_lib.apply_delta(store.graph, delta)
    # Traversals run on the reversed graph: its touched source rows are
    # the ones slot dirtiness is judged against.  Under LT the delta
    # renormalises the mutated destinations only and marks the result
    # normalised, which the sampler then uses as it is (`lt.normalized`):
    # untouched rows keep their bits and ids.
    g_rev, applied_rev = delta_lib.apply_delta(store.g_rev, delta.reversed(),
                                               lt_normalized=lt)
    blocks = delta_lib.touched_row_blocks(applied_rev.touched_rows,
                                          tracker.tile_rows)
    dirty = tracker.dirty_slots(blocks)
    return DeltaPlan(g=g, g_rev=g_rev, applied=applied_fwd,
                     touched_row_blocks=blocks, dirty_slots=dirty,
                     total_slots=len(store.batches))


def apply_plan(store, plan: DeltaPlan) -> tuple[float, float]:
    """Swap the mutated pair into ``store`` and resample its dirty slots
    (same plan → same mutation on every replica of a group).  The touched
    row blocks ride along so a values-only delta patches the sampler's
    frontier index in place (`Sampler.rebind`) instead of rebuilding it.
    Returns the seconds of the rebind and of the resampling, each ended by
    a device synchronisation."""
    dev = plan.g_rev.device
    t0 = time.perf_counter()
    store.apply_graph_update(plan.g, plan.g_rev,
                             touched_row_blocks=plan.touched_row_blocks)
    device_lib.synchronize(dev)
    t1 = time.perf_counter()
    store.resample_slots(plan.dirty_slots)
    device_lib.synchronize(dev)
    return t1 - t0, time.perf_counter() - t1


def incremental_refresh(store, tracker: DirtySlotTracker,
                        delta: delta_lib.EdgeDelta) -> StreamReport:
    """Plan + apply + tracker re-sync for a single store; returns the
    metrics report.  The timed span covers graph swap, sampler rebuild,
    and dirty-slot resampling — the serving-visible cost of the delta."""
    plan = plan_refresh(store, tracker, delta)
    t0 = time.perf_counter()
    rebind_s, resample_s = apply_plan(store, plan)
    refresh_s = time.perf_counter() - t0
    tracker.sync(store)
    tracker.note_delta(len(plan.dirty_slots))
    return report_of(plan, refresh_s, store.graph_epoch, rebind_s,
                     resample_s)


def report_of(plan: DeltaPlan, refresh_s: float, graph_epoch: int,
              rebind_s: float, resample_s: float) -> StreamReport:
    """The `StreamReport` of an applied plan."""
    return StreamReport(
        inserted=plan.applied.inserted, deleted=plan.applied.deleted,
        touched_row_blocks=len(plan.touched_row_blocks),
        dirty_slots=len(plan.dirty_slots), total_slots=plan.total_slots,
        dirty_fraction=plan.dirty_fraction, refresh_s=refresh_s,
        graph_epoch=graph_epoch, rebind_s=rebind_s, resample_s=resample_s)


def cold_rebuild_batches(store) -> list:
    """Every slot of ``store`` rebuilt from scratch on its CURRENT graph
    pair — the bit-identity reference the incremental path is checked
    against (a fresh sampler, same recorded batch indices)."""
    sampler = store._make_sampler(store.graph, store.spec, store.g_rev)
    return sampler.sample_many([b.batch_index for b in store.batches])
