"""Pool of fused-BPT RRR sketch batches (PyTorch port of
``repro.serve.influence.sketch_store``, without persistence).

The store owns a device-resident collection of columnar ``(V, W)`` RRR
bitmask batches (`core.rrr.RRRBatch`) sampled on the reversed graph, under
a device-memory budget.  It implements the sketch-pool protocol that
``core.imm.run_imm`` / ``estimate_theta`` consume (``num_colors``,
``master_seed``, ``ensure``, ``visited_stack``), so offline IMM and the
online `engine.QueryEngine` share one sampled asset.

Freshness is tracked per batch with an epoch tag: ``refresh()`` bumps the
store epoch and resamples the oldest batches at never-used batch indices;
``shrink()`` bumps it too, so ``version`` — the result-cache key — is never
re-issued by a shrink→grow cycle.
"""
from __future__ import annotations

import dataclasses
import math

import torch

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


class SketchStore:
    """Epoch-tagged, budgeted pool of RRR sketch batches on the graph's
    device."""

    def __init__(self, g: csr.Graph, config: PoolConfig | None = None, *,
                 g_rev: csr.Graph | None = None):
        self.graph = g
        self.config = config if config is not None else PoolConfig()
        self.sampler = make_sampler(g, self.config.spec, g_rev=g_rev)
        self.g_rev = self.sampler.g_rev
        self.epoch = 0
        self.graph_epoch = 0
        self.next_batch_index = 0
        self.batches: list[rrr.RRRBatch] = []
        self.batch_epochs: list[int] = []
        self._stack: torch.Tensor | None = None

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
        """Cache key ``(graph_epoch, epoch, count)``: changes on refresh,
        shrink and growth."""
        return (self.graph_epoch, self.epoch, len(self.batches))

    # ----------------------------------------------------------- sampling
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
            new = self.sampler.sample_many(self._take_indices(missing))
            for b in new:
                self.batches.append(b)
                self.batch_epochs.append(self.epoch)
            if self._stack is not None:
                self._stack = torch.cat(
                    [self._stack, rrr.stack_visited(new)])
        return self.batches

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
        if self._stack is not None:
            self._stack = self._stack[:keep]
        return dropped

    def clone(self) -> "SketchStore":
        """A replica pool sharing this store's (never mutated) batches, with
        its own stack and counters: applying the same mutation sequence to
        every clone keeps them bit-identical."""
        c = type(self)(self.graph, self.config, g_rev=self.g_rev)
        c.epoch = self.epoch
        c.graph_epoch = self.graph_epoch
        c.next_batch_index = self.next_batch_index
        c.batches = list(self.batches)
        c.batch_epochs = list(self.batch_epochs)
        return c

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
        new = self.sampler.sample_many(self._take_indices(count))
        for i, b in zip(slots, new):
            self.batches[i] = b
            self.batch_epochs[i] = self.epoch
        if self._stack is not None:
            self._stack[torch.tensor(slots, device=self._stack.device)] = \
                rrr.stack_visited(new)
        return slots
