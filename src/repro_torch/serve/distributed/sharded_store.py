"""Mesh-sharded RRR sketch pool (PyTorch port of
``repro.serve.distributed.sharded_store``), SPMD over a
`distributed.comm.Mesh`.

`ShardedSketchStore` extends `SketchStore` with a placement: slot ``i``
always holds the batch drawn at the store's i-th stream allocation, so an
N-shard pool equals a one-device pool slot for slot; the mesh decides only
where each slot's words live.  Every rank builds the same store and calls
the same methods in the same order.

Layout.  The slot dim is padded to a multiple of the ``axis`` size; shard
``s`` owns the contiguous slot block ``[s·Bp/S, (s+1)·Bp/S)`` (pad slots
are all-zero masks, and the query engine zeroes their active masks).  When
the mesh carries the spec's ``model_axis`` with size M > 1, the vertex
rows are split too: V pads to a multiple of M and each rank holds the
``V/M`` row slice of its slot block.  `visited_stack` is THIS RANK's
``(Bp/S, Vp/M, W)`` block on the graph's device, not the whole stack.

Host bookkeeping is replicated on every rank: ``batches``,
``next_batch_index``, epochs.  Each batch's full ``(V, W)`` mask is kept
in host memory on every rank (the mesh samplers all-gather each block to
every rank, `sampling.sampler`): at the main configuration a 64-batch
pool is 32 MiB of host memory per rank, and each rank receives the
``(D·M − 1)/(D·M)`` of every block it did not compute.  That keeps
snapshots free of any mesh shape (either package restores the other's),
lets a restore re-slot onto any mesh, and lets `refresh` and the streaming
path work from the base class's bookkeeping.  Device residency is the
rank's block alone.

Budget: ``PoolConfig.memory_budget_mb`` is per shard — an N-shard pool
admits N× the batches of a one-device pool, M× more when rows are split.

Persistence: rank 0 writes the snapshot (the base class's manifest, the
shard layout in ``extra``), then every rank meets at a barrier; every rank
reads a snapshot back and places its own block.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import manager
from repro_torch.core import bitmask, rrr
from repro_torch.graph import csr
from repro_torch.sampling import SamplerSpec, make_sampler
from repro_torch.serve.influence.sketch_store import PoolConfig, SketchStore

_HOST = torch.device("cpu")


class ShardedSketchStore(SketchStore):
    """Epoch-tagged sketch pool with slots split over one mesh axis (and
    rows over the spec's model axis, when the mesh has it)."""

    def __init__(self, g: csr.Graph, config: PoolConfig | None = None,
                 mesh=None, *, axis: str = "data",
                 g_rev: csr.Graph | None = None):
        if mesh is None:
            raise ValueError("ShardedSketchStore needs a mesh; use "
                             "SketchStore for single-device pools")
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh {mesh.axis_names}")
        # Set before super().__init__, which builds the sampler through
        # ``_make_sampler``.
        self.mesh = mesh
        self.axis = axis
        super().__init__(g, config, g_rev=g_rev)

    def _make_sampler(self, g: csr.Graph, spec: SamplerSpec, g_rev):
        """The store's mesh backs the mesh backends, their batch blocks on
        the store's slot axis (so each rank samples the slots it holds)."""
        if spec.backend in ("data_parallel", "graph_parallel") \
                and spec.mesh_axis != self.axis:
            spec = spec.replace(mesh_axis=self.axis)
        return make_sampler(g, spec, self.mesh, g_rev=g_rev)

    # ------------------------------------------------------------- layout
    @property
    def num_shards(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def row_axis(self) -> str | None:
        """The mesh axis the vertex rows split over (the spec's
        ``model_axis``), or None when the mesh lacks it or it has size 1."""
        ax = self.config.spec.model_axis
        if ax in self.mesh.axis_names and self.mesh.axis_size(ax) > 1:
            return ax
        return None

    @property
    def row_shards(self) -> int:
        ax = self.row_axis
        return self.mesh.axis_size(ax) if ax is not None else 1

    @property
    def padded_vertices(self) -> int:
        m = self.row_shards
        return -(-self.graph.num_vertices // m) * m

    @property
    def rows_per_shard(self) -> int:
        return self.padded_vertices // self.row_shards

    @property
    def row_offset(self) -> int:
        """The first global row of this rank's row slice."""
        ax = self.row_axis
        return 0 if ax is None else \
            self.mesh.axis_index(ax) * self.rows_per_shard

    @property
    def capacity(self) -> int:
        """Per-shard memory budget × shard count (≥ 1); with rows split,
        a slot takes V/M rows of a device, so the budget admits M× more."""
        cap = self.config.max_batches
        if self.config.memory_budget_mb is not None:
            per_slot = -(-self.bytes_per_batch // self.row_shards)
            per_shard = int(self.config.memory_budget_mb * 2 ** 20
                            // per_slot)
            cap = min(cap, per_shard * self.num_shards)
        return max(cap, 1)

    @property
    def padded_batches(self) -> int:
        s = self.num_shards
        return -(-len(self.batches) // s) * s

    @property
    def slots_per_shard(self) -> int:
        return self.padded_batches // self.num_shards

    @property
    def slot_offset(self) -> int:
        """The first slot of this rank's slot block."""
        return self.mesh.axis_index(self.axis) * self.slots_per_shard

    def shard_layout(self) -> list[int]:
        """slot → owning shard (contiguous blocks over the padded slots)."""
        per = self.slots_per_shard
        return [i // per for i in range(len(self.batches))]

    # ----------------------------------------------------------- sampling
    def _sample_block(self, batch_indices: list[int]) -> list[rrr.RRRBatch]:
        # Host-stage every mask: device residency is the rank's block of
        # the stack alone, or the sampling device would hold the pool.
        return [dataclasses.replace(b, visited=b.visited.to(_HOST))
                for b in super()._sample_block(batch_indices)]

    def _clone_empty(self) -> "ShardedSketchStore":
        return type(self)(self.graph, self.config, self.mesh, axis=self.axis,
                          g_rev=self.g_rev)

    def _extend_stack(self, new_batches) -> None:
        # Growth moves every shard's block boundaries: re-place lazily.
        self._stack = None

    def _truncate_stack(self, keep: int) -> None:
        self._stack = None

    # -------------------------------------------------------------- stack
    def visited_stack(self) -> torch.Tensor:
        """This rank's ``(Bp/S, Vp/M, W)`` block of the padded stack on the
        graph's device, placed from the host-staged batches (kept until
        the slot count changes; `refresh` writes it in place)."""
        if not self.batches:
            raise ValueError("empty pool — call ensure() first")
        if self._stack is None:
            per, lo = self.slots_per_shard, self.slot_offset
            rlo, vloc = self.row_offset, self.rows_per_shard
            w = bitmask.num_words(self.num_colors)
            blk = torch.zeros((per, vloc, w), dtype=torch.int32,
                              device=self.graph.device)
            for i, b in enumerate(self.batches[lo:lo + per]):
                rows = b.visited[rlo:rlo + vloc]
                blk[i, :rows.shape[0]] = rows.to(blk.device)
            self._stack = blk
        return self._stack

    def _update_stack(self, slots, new_batches) -> None:
        """Rewrite this rank's rows of the given slots that it holds."""
        if self._stack is None:
            return
        per, lo = self.slots_per_shard, self.slot_offset
        rlo, vloc = self.row_offset, self.rows_per_shard
        for slot, b in zip(slots, new_batches):
            if lo <= slot < lo + per:
                rows = b.visited[rlo:rlo + vloc]
                self._stack[slot - lo].zero_()
                self._stack[slot - lo, :rows.shape[0]] = \
                    rows.to(self._stack.device)

    # -------------------------------------------------------- persistence
    def _manifest_extra(self) -> dict:
        """The shard layout beside the base class's `SamplerSpec`: the
        mesh shape, the slot → shard map and the row layout the pool
        served under — metadata, not constraints, since the leaves are
        global host arrays."""
        return {**super()._manifest_extra(),
                "kind": "sharded_sketch_pool",
                "mesh_axis": self.axis,
                "num_shards": self.num_shards,
                "mesh_shape": dict(self.mesh.shape),
                "shard_layout": self.shard_layout(),
                "row_layout": {"axis": self.row_axis,
                               "shards": self.row_shards,
                               "padded_vertices": self.padded_vertices}}

    def save(self, directory: str, *, keep: int = 3) -> None:
        """Rank 0 writes the snapshot; every rank returns once it is
        published."""
        if self.mesh.rank == 0:
            super().save(directory, keep=keep)
        self.mesh.barrier()

    @staticmethod
    def saved_layout(directory: str, step: int | None = None) -> dict:
        """The ``extra`` a snapshot was written under (a plain
        `SketchStore`'s has no shard layout)."""
        return manager.read_manifest(directory, step).get("extra", {})

    @classmethod
    def restore(cls, directory: str, g: csr.Graph,
                config: PoolConfig | None = None, mesh=None, *,
                axis: str = "data", step: int | None = None,
                g_rev: csr.Graph | None = None) -> "ShardedSketchStore":
        """Rebuild a bit-identical pool re-slotted onto ``mesh`` — any shape
        along the slot and row axes, whatever mesh (or single device, or
        package) wrote the snapshot.  Every rank reads the snapshot's
        global arrays into host memory and places its own block.

        With no ``config`` the snapshot's `SamplerSpec` is adopted.  A
        ``graph_parallel`` spec needs the new mesh to carry its model axis
        (later refreshes row-partition the graph); a diffusion mismatch
        raises (base class)."""
        step, manifest = cls._resolve_snapshot(directory, step)
        extra = manifest.get("extra", {})
        if config is None:
            saved = extra.get("sampler_spec")
            config = PoolConfig(spec=SamplerSpec.from_manifest(saved)) \
                if saved else PoolConfig()
        spec = config.spec
        if spec.backend == "graph_parallel" and (
                mesh is None or spec.model_axis not in mesh.axis_names):
            raise ValueError(
                f"layout mismatch: a graph_parallel pool needs a mesh with "
                f"model axis {spec.model_axis!r} to refresh, but the restore "
                f"mesh has axes {mesh.axis_names if mesh else ()} (snapshot "
                f"written under mesh_shape {extra.get('mesh_shape')})")
        config, epoch, nbi, batches, epochs, gepoch = cls._restored_fields(
            directory, config, step, _HOST, manifest=manifest)
        store = cls(g, config, mesh, axis=axis, g_rev=g_rev)
        store.epoch = epoch
        store.graph_epoch = gepoch
        store.next_batch_index = nbi
        store.batches = batches
        store.batch_epochs = epochs
        store.visited_stack()
        return store
