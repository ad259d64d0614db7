"""Persistent pool of fused-BPT RRR sketch batches (PyTorch port of
``repro.serve.influence.sketch_store``).

The store owns a device-resident collection of columnar ``(V, W)`` RRR
bitmask batches (`core.rrr.RRRBatch`) sampled on the reversed graph, under
a device-memory budget.  It implements the sketch-pool protocol that
``core.imm.run_imm`` / ``estimate_theta`` consume (``num_colors``,
``master_seed``, ``ensure``, ``visited_stack``), so offline IMM and the
online `engine.QueryEngine` share one sampled asset.

Freshness is tracked per batch with an epoch tag: ``refresh()`` bumps the
store epoch and resamples the oldest batches at never-used batch indices;
``shrink()`` bumps it too, so ``version`` — the result-cache key — is never
re-issued by a shrink→grow cycle.  A streaming graph delta
(`repro_torch.stream`) swaps in a mutated graph pair
(``apply_graph_update``, which bumps ``graph_epoch``) and re-derives the
dirty slots from their recorded batch indices (``resample_slots``).

Persistence rides the checkpoint manifest format (`checkpoint.manager`):
``save()`` writes an atomic ``step_<N>/{manifest.json, leaf_*.npy}``
snapshot of the masks (as uint32), roots, indices, epochs, edge visits and
the five counters, with the `SamplerSpec` in the manifest ``extra`` —
leaf for leaf the reference's snapshot, so each package restores the
other's.  ``SketchStore.restore`` rebuilds a bit-identical pool and refuses
a diffusion or colour mismatch.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import manager
from repro_torch.core import bitmask, rrr
from repro_torch.graph import csr
from repro_torch.sampling import SamplerSpec, make_sampler, resolve_spec


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Sizing + sampling knobs for a sketch pool.

    ``memory_budget_mb`` (when set) caps ``max_batches`` by the bytes of one
    ``(V, W)`` batch.  ``spec`` is always a resolved `SamplerSpec` after
    ``__post_init__``; ``num_colors``/``master_seed`` are adopted from it,
    and an explicitly set value that disagrees with it raises.
    """
    num_colors: int | None = None
    max_batches: int = 64
    memory_budget_mb: float | None = None
    master_seed: int | None = None
    spec: SamplerSpec | None = None

    def __post_init__(self):
        spec = resolve_spec(self.spec, num_colors=self.num_colors,
                            master_seed=self.master_seed)
        object.__setattr__(self, "num_colors", spec.num_colors)
        object.__setattr__(self, "master_seed", spec.master_seed)
        object.__setattr__(self, "spec", spec)

    def with_master_seed(self, master_seed: int) -> "PoolConfig":
        """Config with ``master_seed`` replaced in the spec too (restore
        adopts a snapshot's seed this way)."""
        return dataclasses.replace(
            self, master_seed=master_seed,
            spec=self.spec.replace(master_seed=master_seed))


class SketchStore:
    """Epoch-tagged, budgeted pool of RRR sketch batches on the graph's
    device."""

    def __init__(self, g: csr.Graph, config: PoolConfig | None = None, *,
                 g_rev: csr.Graph | None = None):
        self.graph = g
        self.config = config if config is not None else PoolConfig()
        self.sampler = self._make_sampler(g, self.config.spec, g_rev)
        self.g_rev = self.sampler.g_rev
        self.epoch = 0
        self.graph_epoch = 0
        self.next_batch_index = 0
        self.batches: list[rrr.RRRBatch] = []
        self.batch_epochs: list[int] = []
        self._stack: torch.Tensor | None = None

    def _make_sampler(self, g: csr.Graph, spec: SamplerSpec,
                      g_rev: csr.Graph | None):
        return make_sampler(g, spec, g_rev=g_rev)

    # ------------------------------------------------------------- sizing
    @property
    def spec(self) -> SamplerSpec:
        return self.config.spec

    @property
    def num_colors(self) -> int:
        return self.config.num_colors

    @property
    def master_seed(self) -> int:
        return self.config.master_seed

    @property
    def bytes_per_batch(self) -> int:
        return self.graph.num_vertices * bitmask.num_words(
            self.config.num_colors) * 4

    @property
    def capacity(self) -> int:
        """Max batches the budget admits (≥ 1 so the pool is never unusable)."""
        cap = self.config.max_batches
        if self.config.memory_budget_mb is not None:
            cap = min(cap, int(self.config.memory_budget_mb * 2 ** 20
                               // self.bytes_per_batch))
        return max(cap, 1)

    @property
    def num_samples(self) -> int:
        return len(self.batches) * self.config.num_colors

    @property
    def version(self) -> tuple[int, int, int]:
        """Cache key ``(graph_epoch, epoch, count)``: changes on a graph
        delta, on refresh, on shrink and on growth."""
        return (self.graph_epoch, self.epoch, len(self.batches))

    # ----------------------------------------------------------- sampling
    def _sample_block(self, batch_indices: list[int]) -> list[rrr.RRRBatch]:
        return self.sampler.sample_many(batch_indices)

    def _take_indices(self, count: int) -> list[int]:
        """Allocate ``count`` never-before-used batch indices (RNG streams)."""
        idx = list(range(self.next_batch_index, self.next_batch_index + count))
        self.next_batch_index += count
        return idx

    def ensure(self, num_batches: int) -> list[rrr.RRRBatch]:
        """Grow the pool to ≥ ``num_batches`` (clamped to capacity); returns
        the live batch list (callers must not mutate it)."""
        want = min(num_batches, self.capacity)
        missing = want - len(self.batches)
        if missing > 0:
            new = self._sample_block(self._take_indices(missing))
            for b in new:
                self.batches.append(b)
                self.batch_epochs.append(self.epoch)
            self._extend_stack(new)
        return self.batches

    def _extend_stack(self, new_batches: list[rrr.RRRBatch]) -> None:
        """Append grown slots to the stack (no-op while it is unbuilt)."""
        if self._stack is not None:
            self._stack = torch.cat([self._stack,
                                     rrr.stack_visited(new_batches)])

    def _truncate_stack(self, keep: int) -> None:
        if self._stack is not None:
            self._stack = self._stack[:keep]

    def shrink(self, num_batches: int) -> list[int]:
        """Drop the highest slots down to ``num_batches`` (floor 1); returns
        the dropped slots.  Bumps the epoch when anything is dropped, so a
        later grow to the same count never repeats a ``version``."""
        keep = max(1, min(int(num_batches), len(self.batches)))
        dropped = list(range(keep, len(self.batches)))
        if not dropped:
            return dropped
        self.epoch += 1
        self.batches = self.batches[:keep]
        self.batch_epochs = self.batch_epochs[:keep]
        self._truncate_stack(keep)
        return dropped

    def clone(self) -> "SketchStore":
        """A replica pool sharing this store's (never mutated) batches, with
        its own stack and counters: applying the same mutation sequence to
        every clone keeps them bit-identical."""
        c = self._clone_empty()
        c.epoch = self.epoch
        c.graph_epoch = self.graph_epoch
        c.next_batch_index = self.next_batch_index
        c.batches = list(self.batches)
        c.batch_epochs = list(self.batch_epochs)
        return c

    def _clone_empty(self) -> "SketchStore":
        return type(self)(self.graph, self.config, g_rev=self.g_rev)

    def visited_stack(self) -> torch.Tensor:
        """(B, V, W) stacked masks for the query engine (built once, then
        kept up to date by every mutation)."""
        if not self.batches:
            raise ValueError("empty pool — call ensure() first")
        if self._stack is None:
            self._stack = rrr.stack_visited(self.batches)
        return self._stack

    # ------------------------------------------------------------ refresh
    def refresh(self, fraction: float = 0.25) -> list[int]:
        """Resample the oldest-epoch batches with fresh RNG streams.

        Bumps the store epoch, then replaces ``ceil(fraction · B)`` batches
        (oldest epoch tag first, lowest slot on ties) with new samples drawn
        at never-before-used batch indices.  Returns the replaced slots.  The
        stack is rewritten in place: a stack returned earlier by
        ``visited_stack()`` sees the new slots.
        """
        if not self.batches:
            return []
        self.epoch += 1
        count = min(len(self.batches),
                    max(1, math.ceil(fraction * len(self.batches))))
        order = sorted(range(len(self.batches)),
                       key=lambda i: (self.batch_epochs[i], i))
        slots = order[:count]
        new = self._sample_block(self._take_indices(count))
        for i, b in zip(slots, new):
            self.batches[i] = b
            self.batch_epochs[i] = self.epoch
        self._update_stack(slots, new)
        return slots

    def _update_stack(self, slots: list[int],
                      new_batches: list[rrr.RRRBatch]) -> None:
        """Write the given slots of the stack in place (no-op while it is
        unbuilt): a stack returned earlier by ``visited_stack()`` sees the
        new slots."""
        if self._stack is not None:
            self._stack[torch.tensor(slots, device=self._stack.device)] = \
                rrr.stack_visited(new_batches)

    # ---------------------------------------------------- streaming deltas
    def apply_graph_update(self, g: csr.Graph, g_rev: csr.Graph,
                           touched_row_blocks=None) -> None:
        """Swap in a mutated graph pair (`repro_torch.stream.apply_delta`
        output: edge ids stable, ``g_rev`` maintained by the reversed delta,
        never `csr.transpose`) and bump the graph epoch.  The sampler is
        rebound (`Sampler.rebind`): a values-only delta naming its
        ``touched_row_blocks`` patches the sparse frontier index in place,
        anything else rebuilds the sampler's layouts.  Batches keep their
        recorded batch indices, so `resample_slots` re-derives any slot on
        the new pair.  A compacted (renumbered) pair is fine too; then every
        slot must be resampled, as `stream.compact_store` does."""
        self.graph = g
        self.sampler = self.sampler.rebind(g, g_rev, touched_row_blocks)
        self.g_rev = self.sampler.g_rev
        self.graph_epoch += 1

    def resample_slots(self, slots: list[int]) -> list[rrr.RRRBatch]:
        """Re-derive the given slots from their recorded batch indices on
        the current graph (no new indices, no epoch bump): after a delta
        they equal a cold rebuild of the same indices bit for bit.  The
        stack is written in place."""
        if not slots:
            return []
        new = self._sample_block([self.batches[i].batch_index
                                  for i in slots])
        for i, b in zip(slots, new):
            self.batches[i] = b
        self._update_stack(slots, new)
        return new

    # -------------------------------------------------------- persistence
    def _tree(self) -> dict:
        """The snapshot's leaves, with the reference's dtypes and shapes
        (masks as uint32)."""
        return {
            "visited": convert.masks_to_numpy(
                rrr.stack_visited(self.batches)),
            "roots": np.stack([np.asarray(b.roots, np.int32)
                               for b in self.batches]),
            "batch_indices": np.asarray(
                [b.batch_index for b in self.batches], np.int64),
            "batch_epochs": np.asarray(self.batch_epochs, np.int64),
            "edge_visits": np.asarray(
                [[b.fused_edge_visits, b.unfused_edge_visits]
                 for b in self.batches], np.int64),
            "counters": np.asarray(
                [self.epoch, self.next_batch_index,
                 self.config.master_seed, self.config.num_colors,
                 self.graph_epoch], np.int64),
        }

    def _manifest_extra(self) -> dict:
        """Manifest ``extra``: the `SamplerSpec` always rides along so
        restore can refuse a diffusion mismatch."""
        return {"kind": "sketch_pool",
                "sampler_spec": self.config.spec.to_manifest()}

    def save(self, directory: str, *, keep: int = 3) -> None:
        """Atomic manifest snapshot; step number = store epoch."""
        manager.save(directory, self.epoch, self._tree(), keep=keep,
                     extra=self._manifest_extra())

    @classmethod
    def _resolve_snapshot(cls, directory: str, step: int | None):
        """(step, manifest) of the latest (or given) snapshot."""
        step = step if step is not None else manager.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no sketch-pool snapshot in {directory}")
        return step, manager.read_manifest(directory, step)

    @classmethod
    def _restored_fields(cls, directory: str, config: PoolConfig,
                         step: int | None, device,
                         manifest: dict | None = None):
        """(config, epoch, next_batch_index, batches, batch_epochs,
        graph_epoch) of a snapshot, the masks placed on ``device``."""
        if manifest is None:
            step, manifest = cls._resolve_snapshot(directory, step)
        saved_spec = manifest.get("extra", {}).get("sampler_spec")
        if saved_spec is not None:
            saved = SamplerSpec.from_manifest(saved_spec)
            if saved.diffusion != config.spec.diffusion:
                raise ValueError(
                    f"snapshot was sampled under diffusion "
                    f"{saved.diffusion!r} but the restore config requests "
                    f"{config.spec.diffusion!r} — an IC pool must never be "
                    "served as LT (or vice versa); restore with a matching "
                    "SamplerSpec")
        target = {e["path"]: np.zeros(e["shape"], np.dtype(e["dtype"]))
                  for e in manifest["leaves"]}
        tree, _ = manager.restore(directory, target, step, as_numpy=True)
        counters = tree["counters"]
        if int(counters[3]) != config.num_colors:
            raise ValueError(f"snapshot colors {int(counters[3])} != "
                             f"config {config.num_colors}")
        config = config.with_master_seed(int(counters[2]))
        masks = convert.masks_from_numpy(tree["visited"], device)
        roots = tree["roots"].astype(np.int32)
        indices = tree["batch_indices"]
        visits = tree["edge_visits"]
        batches = [rrr.RRRBatch(masks[i], roots[i], int(indices[i]),
                                int(visits[i, 0]), int(visits[i, 1]))
                   for i in range(masks.shape[0])]
        epochs = [int(e) for e in tree["batch_epochs"]]
        # Snapshots from before streaming carry 4 counters: graph epoch 0.
        graph_epoch = int(counters[4]) if counters.shape[0] > 4 else 0
        return (config, int(counters[0]), int(counters[1]), batches, epochs,
                graph_epoch)

    @classmethod
    def restore(cls, directory: str, g: csr.Graph,
                config: PoolConfig | None = None, *,
                step: int | None = None,
                g_rev: csr.Graph | None = None) -> "SketchStore":
        """Rebuild a bit-identical pool from the latest (or given) snapshot,
        on ``g``'s device."""
        config, epoch, nbi, batches, epochs, gepoch = cls._restored_fields(
            directory, config if config is not None else PoolConfig(), step,
            g.device)
        store = cls(g, config, g_rev=g_rev)
        store.epoch = epoch
        store.graph_epoch = gepoch
        store.next_batch_index = nbi
        store.batches = batches
        store.batch_epochs = epochs
        return store
