"""1-D destination-row partition of a tile layout for graph-parallel
traversal (PyTorch port of ``repro.graph.partition``).

Shard ``s`` owns destination blocks ``[s·nbₗ, (s+1)·nbₗ)`` — rows
``[s·rows, (s+1)·rows)`` of every visited mask, ``rows = nbₗ·T`` — and
every adjacency tile whose destination falls there, so it writes only its
own rows; source rows arrive through the per-level frontier exchange.  The
assignment is a pure function of ``(layout, num_shards)``: the destination
block of a tile, over ``nbₗ = ceil(ceil(V/T) / S)``.

A rank of the mesh paths builds only its own shard, as a `ShardLayout`:
the shard's edges in slot-list order, straight from the CSR edges (the
host part of `core.tiles.from_graph`), with global source rows and local
destination rows (``dst_row − s·rows``).  The reference's stacked
``(S, ntₘ, T, T)`` form is not ported: at 65,536 vertices it takes ~26 GB
of host memory per rank, and no path of the port reads it (the tests read
the reference's stacks).  `ShardLayout.slot_list` turns per-edge values
and keys into the shard's `core.tiles.SlotList`; a values-only graph
delta (same ``(src, dst)`` at every edge slot) reuses the layout and
re-derives the list (the counterpart of the reference sampler's cached
``edge_slot_map`` and per-shard tile lists).  Padding tiles would carry
no entries, so the list has none.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import tiles


def blocks_per_shard(num_vertices: int, tile_size: int,
                     num_shards: int) -> int:
    """``nbₗ``: destination blocks per shard."""
    n_blocks = -(-num_vertices // tile_size)
    return -(-n_blocks // num_shards)


def shard_rows(num_vertices: int, tile_size: int, num_shards: int,
               shard: int) -> tuple[int, int]:
    """``(row_base, rows)``: the visited rows shard ``shard`` holds (the
    role of the reference's ``partition_specs``)."""
    rows = blocks_per_shard(num_vertices, tile_size, num_shards) * tile_size
    return shard * rows, rows


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Shard ``shard`` of ``num_shards`` of a graph's tile layout, as the
    shard's CSR edges in slot-list order (per local tile in tile order;
    within a tile by destination lane, then source row)."""
    shard: int
    num_shards: int
    tile_size: int
    num_vertices: int
    blocks_per_shard: int
    num_tiles: int              # the shard's tiles
    eids: np.ndarray            # (n,) int64 CSR edge ids
    tile: np.ndarray            # (n,) int64 local tile of each edge
    src_row: np.ndarray         # (n,) int32 global source row
    dst_row: np.ndarray         # (n,) int32 local destination row

    @property
    def rows(self) -> int:
        return self.blocks_per_shard * self.tile_size

    @property
    def row_base(self) -> int:
        return self.shard * self.rows

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.rows

    def slot_list(self, values: np.ndarray, keys: np.ndarray,
                  device) -> tiles.SlotList:
        """The shard's `core.tiles.SlotList` on ``device``: the edges whose
        per-CSR-edge float32 ``values`` are > 0 (the kernels' test), each
        with its int32 ``keys`` entry (the edge id for IC, the bits of the
        selection-CDF prefix for LT)."""
        v = np.asarray(values, np.float32)[self.eids]
        keep = v > 0
        ptr = np.zeros(self.num_tiles + 1, np.int64)
        ptr[1:] = np.cumsum(np.bincount(self.tile[keep],
                                        minlength=self.num_tiles))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return tiles.SlotList(
            slot_ptr=dev(ptr.astype(np.int32)),
            src_row=dev(self.src_row[keep]), dst_row=dev(self.dst_row[keep]),
            value=dev(v[keep]),
            key=dev(np.asarray(keys).astype(np.int32, copy=False)
                    [self.eids[keep]]),
            src_rows=self.padded_vertices, dst_rows=self.rows)


def shard_layout(g, tile_size: int, num_shards: int,
                 shard: int) -> ShardLayout:
    """Shard ``shard``'s `ShardLayout` of the tile layout of ``g`` (the
    reversed graph a sampler traverses), from its CSR edges on the host.
    Raises on parallel edges, as `core.tiles.from_graph` does."""
    T = tile_size
    nb_loc = blocks_per_shard(g.num_vertices, T, num_shards)
    rows = nb_loc * T
    empty = np.zeros(0, np.int64)
    if g.num_edges == 0:
        return ShardLayout(shard, num_shards, T, g.num_vertices, nb_loc, 0,
                           empty, empty, empty.astype(np.int32),
                           empty.astype(np.int32))
    src, dst, _ = g.edges_numpy()
    order, uniq, flat, base = tiles._tile_keys(src, dst, T)
    if len(np.unique(flat)) != len(flat):
        raise ValueError("parallel edges present — run csr.dedupe / "
                         "csr.from_edges(..., dedupe=True) first")
    tile = flat // (T * T)                      # global tile of sorted edge
    shard_of_tile = (uniq // base) // nb_loc
    mine = np.flatnonzero(shard_of_tile == shard)
    sel = np.flatnonzero(shard_of_tile[tile] == shard)
    i = flat[sel] % (T * T) // T
    j = flat[sel] % T
    perm = np.argsort(tile[sel] * (T * T) + j * T + i, kind="stable")
    eids = order[sel][perm].astype(np.int64)
    return ShardLayout(
        shard=shard, num_shards=num_shards, tile_size=T,
        num_vertices=g.num_vertices, blocks_per_shard=nb_loc,
        num_tiles=len(mine), eids=eids,
        tile=np.searchsorted(mine, tile[sel][perm]),
        src_row=src[eids].astype(np.int32),
        dst_row=(dst[eids].astype(np.int64) - shard * rows).astype(np.int32))
