"""Block-sparse adjacency tiles (PyTorch port of ``repro.core.tiles``).

The adjacency ``A[src, dst]`` of the (reversed) graph is a list of
non-empty ``T×T`` tiles sorted by destination block, each carrying

  * ``prob``    (T, T) float32 — IC activation probability (0 ⇒ no edge),
  * ``edge_id`` (T, T) int32   — the edge's CSR index, the RNG counter that
    makes the tile path draw the CSR path's exact Bernoulli realization
    (IC only: an LT layout, built with ``edge_ids=False``, has none).

The layout is the reference's, array for array (``from_graph`` mirrors its
sort/unique), except that the reference's ``first_of_dst`` run-start flags
give way to ``dst_run_ptr``, the ``(n_blocks + 1,)`` offsets of each
destination block's tile run: one CTA per destination block of the CUDA
kernel finds its tiles there without a search or a cross-tile
accumulation.

The stacks are not built in host memory: at 65,536 vertices they take
24 GiB.  The host computes each edge's flat slot (``edge_slot_map``);
zeros are allocated on the device and ``prob``/``edge_id`` scattered there.

The quantised layout (`quantized`) keeps the same tile list with one
uint8 threshold per slot beside it (1 B where ``prob`` and ``edge_id``
take 8) and no other stack: the kernel that reads it
(`kernels.ops.fused_expand_q`) draws by slot position, not edge id.

The three tile kernels walk a `SlotList` instead of the stacks: per tile,
the slots whose value passes the kernel's own test (``prob > 0``,
``q > 0``), each with its source and destination rows and what its draw
or its live-edge test needs.  At 65,536 vertices it is 382,080 entries
(6 MB) beside 24 GiB of stacks.  `ic_slot_list`, `q_slot_list` and
`lt_slot_list` build it once per stack and memoise it (`from_graph`,
`quantized` and `lt_cb_tiles` build it from their host arrays; any other
stack is read in chunks of tiles).
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bitmask import MASK32, i32
from repro_torch.graph.csr import Graph

TILE = 128
# Slots per chunk of a slot-list build from a stack: bounds the transient
# mask and keeps every ``nonzero`` far below 2**31 elements (the q8 stack
# at 262,144 vertices holds ~9.7e9 slots).
SLOT_CHUNK = 2 ** 26


@dataclasses.dataclass(frozen=True)
class TiledGraph:
    """Block-sparse adjacency (see module docstring)."""
    prob: torch.Tensor | None   # (nt, T, T) float32; None on the
    #                             quantised layout (`quantized`)
    edge_id: torch.Tensor | None  # (nt, T, T) int32 (0 ok: prob gates
    #                               validity); None without IC draws
    tile_src: torch.Tensor      # (nt,) int32  source block index
    tile_dst: torch.Tensor      # (nt,) int32  destination block (sorted)
    dst_run_ptr: torch.Tensor   # (n_blocks + 1,) int32  tile run offsets
    num_vertices: int
    num_edges: int
    tile_size: int

    @property
    def num_tiles(self) -> int:
        return int(self.tile_src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tile_src.device

    @property
    def padded_vertices(self) -> int:
        return -(-self.num_vertices // self.tile_size) * self.tile_size

    @property
    def num_blocks(self) -> int:
        return self.padded_vertices // self.tile_size

    @property
    def occupancy(self) -> float:
        """Edges per stored tile slot — the reordering cost model."""
        return self.num_edges / (max(self.num_tiles, 1) * self.tile_size ** 2)


@dataclasses.dataclass(frozen=True)
class SlotList:
    """The nonzero slots of one tile stack, grouped by tile in tile order
    and, within a tile, sorted by destination lane ``j`` then source row
    ``i`` (neighbouring entries share destination rows).  Entry ``e`` of
    tile ``t`` (``slot_ptr[t] <= e < slot_ptr[t + 1]``) is slot ``(i, j)``:

      * ``src_row[e] = tile_src[t]·T + i``, ``dst_row[e] = tile_dst[t]·T + j``
        (int32 rows of the frontier and visited masks);
      * ``value[e]``: the float32 probability (IC, LT) or the uint8
        threshold ``q`` (quantised) — only slots with ``value > 0`` are
        listed, the kernels' own test (``q = 0`` for ``0 < p < 1.5/256``
        never crosses);
      * ``key[e]``: int32 bits — the RNG counter: the CSR edge id (IC) or
        the cell ``(t·T² + i·T + j) mod 2³²`` of the original tile id
        (quantised); LT: the selection-CDF prefix, as float32 bits.

    ``src_rows`` and ``dst_rows`` bound the rows the entries index in the
    frontier and in the visited and output masks: equal on one device; a
    row shard's list (`graph.partition.ShardLayout`) reads the global
    frontier and writes its local rows."""
    slot_ptr: torch.Tensor      # (nt + 1,) int32
    src_row: torch.Tensor       # (n,) int32
    dst_row: torch.Tensor       # (n,) int32
    value: torch.Tensor         # (n,) float32 prob or uint8 q
    key: torch.Tensor           # (n,) int32 edge id or cell
    src_rows: int
    dst_rows: int

    @property
    def num_entries(self) -> int:
        return int(self.src_row.shape[0])

    @property
    def num_tiles(self) -> int:
        return int(self.slot_ptr.shape[0]) - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.slot_ptr, self.src_row, self.dst_row, self.value, self.key))


def dedupe_edges(src: np.ndarray, dst: np.ndarray, prob: np.ndarray):
    """Combine parallel (src, dst) duplicates: p = 1 - Π(1 - p_i) (float64
    log-space accumulation, as the reference)."""
    key = src.astype(np.int64) * (dst.max() + 1 if len(dst) else 1) + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, prob = key[order], src[order], dst[order], prob[order]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    log_keep = np.log1p(-np.clip(prob, 0.0, 1.0 - 1e-7))
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv, log_keep)
    return src[first], dst[first], (1.0 - np.exp(acc)).astype(np.float32)


def _tile_keys(src: np.ndarray, dst: np.ndarray, tile_size: int):
    """(order, unique tile keys, flat slot per sorted edge, key base) — the
    sort/unique that fixes the tile layout: dst-block major, src minor."""
    ts, td = src // tile_size, dst // tile_size
    base = int(ts.max()) + 1
    tile_key = td.astype(np.int64) * base + ts
    order = np.argsort(tile_key, kind="stable")
    uniq, inv = np.unique(tile_key[order], return_inverse=True)
    li, lj = src[order] % tile_size, dst[order] % tile_size
    flat = (inv.astype(np.int64) * tile_size * tile_size
            + li.astype(np.int64) * tile_size + lj)
    return order, uniq, flat, base


def edge_slot_map(g: Graph, tile_size: int = TILE):
    """``(slot (E,) int64, num_tiles)``: CSR edge id → flat index into the
    ``(nt·T·T,)`` raveled tile stacks of ``from_graph(g, tile_size)``."""
    e = g.num_edges
    if e == 0:
        return np.zeros(0, np.int64), 0
    src, dst, _ = g.edges_numpy()
    order, uniq, flat, _ = _tile_keys(src, dst, tile_size)
    slot = np.empty(e, np.int64)
    slot[order] = flat                 # flat[j] is the slot of edge order[j]
    return slot, len(uniq)


def run_pointers(tile_dst: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(n_blocks + 1,) int32 on ``tile_dst``'s device: entries
    ``[ptr[b], ptr[b+1])`` of the dst-sorted list ``tile_dst`` belong to
    destination block ``b`` (an empty run for blocks no tile reaches).
    ``tile_dst`` may be the whole layout's or a compacted list's
    (``tile_dst[ids]`` of ascending ids is still sorted)."""
    blocks = torch.arange(n_blocks + 1, dtype=tile_dst.dtype,
                          device=tile_dst.device)
    return torch.searchsorted(tile_dst, blocks, out_int32=True)


def _layout(g: Graph, tile_size: int, pad_tiles_to: int | None):
    """The host part of a tile layout: ``(order, slots, prob, tile_src,
    tile_dst, total)`` — each sorted edge's CSR id (``order``) and flat
    slot on ``g``'s device, the host copy of ``g.prob``, the tile list as
    numpy, and the tile count with ``pad_tiles_to`` padding tiles."""
    src, dst, prob = g.edges_numpy()
    order, uniq, flat, base = _tile_keys(src, dst, tile_size)
    # Duplicate (src, dst) pairs must have been merged (dedupe_edges) — check.
    if len(np.unique(flat)) != len(flat):
        raise ValueError("parallel edges present — run tiles.dedupe_edges / "
                         "csr.from_edges(..., dedupe=True) first")
    nt = len(uniq)
    t_src = (uniq % base).astype(np.int32)
    t_dst = (uniq // base).astype(np.int32)

    total = nt
    if pad_tiles_to is not None:
        if pad_tiles_to < nt:
            raise ValueError(f"pad_tiles_to={pad_tiles_to} < num_tiles={nt}")
        pad = pad_tiles_to - nt
        if pad:
            # Padding tiles join the last dst block's run with prob 0 —
            # pure no-ops that keep shapes static.
            t_src = np.concatenate([t_src, np.full(pad, t_src[-1], np.int32)])
            t_dst = np.concatenate([t_dst, np.full(pad, t_dst[-1], np.int32)])
        total = pad_tiles_to
    return (order, torch.from_numpy(flat).to(g.device), prob, t_src, t_dst,
            total)


def _tiled(g: Graph, tile_size: int, t_src, t_dst, prob, edge_id):
    dev = g.device
    n_blocks = -(-g.num_vertices // tile_size)
    return TiledGraph(
        prob=prob, edge_id=edge_id,
        tile_src=torch.from_numpy(t_src).to(dev),
        tile_dst=torch.from_numpy(t_dst).to(dev),
        dst_run_ptr=run_pointers(torch.from_numpy(t_dst).to(dev), n_blocks),
        num_vertices=g.num_vertices, num_edges=g.num_edges,
        tile_size=tile_size)


def from_graph(g: Graph, tile_size: int = TILE,
               pad_tiles_to: int | None = None,
               edge_ids: bool = True) -> TiledGraph:
    """Extract the non-empty tile list of ``g`` onto ``g``'s device.
    ``edge_ids=False`` leaves out the ``edge_id`` stack, which only the IC
    draw reads (an LT layout would carry 12.1 GiB of it unread at
    n = 65,536); only an IC layout gets a slot list here (`ic_slot_list`;
    an LT layout's comes with its cb stack, `lt_cb_tiles`)."""
    dev = g.device
    order, slots, prob, t_src, t_dst, total = _layout(g, tile_size,
                                                      pad_tiles_to)
    P = torch.zeros(total * tile_size * tile_size, dtype=torch.float32,
                    device=dev)
    pv = torch.from_numpy(prob[order]).to(dev)
    P[slots] = pv
    E = None
    if edge_ids:
        E = torch.zeros_like(P, dtype=torch.int32)
        ev = torch.from_numpy(order.astype(np.int32)).to(dev)
        E[slots] = ev
        E = E.view(total, tile_size, tile_size)
    tg = _tiled(g, tile_size, t_src, t_dst,
                P.view(total, tile_size, tile_size), E)
    if edge_ids:
        keep = pv > 0
        _remember((tg.prob, tg.edge_id, tg.tile_src, tg.tile_dst),
                  _slots_from_flat(slots[keep], pv[keep], ev[keep], tg,
                                   total))
    return tg


def quantized(g: Graph,
              tile_size: int = TILE) -> tuple[TiledGraph, torch.Tensor]:
    """The quantised layout of ``g`` on its device: ``(tg, q8)``.  ``tg``
    is ``from_graph``'s tile list without stacks (``prob`` and ``edge_id``
    None); ``q8`` is the ``(nt, T, T)`` uint8 threshold stack that rides
    beside it, `kernels.fused_expand_q.quantize_probs` of each edge's
    probability scattered into its slot, 0 where no edge lies.  It equals
    the reference's ``quantize_probs(from_graph(g).prob)`` without building
    the float32 stack (36 GiB at 262,144 vertices, where ``q8`` takes 9).
    Its slot list (`q_slot_list`) is built here from the same arrays."""
    from repro_torch.kernels.fused_expand_q import quantize_probs

    dev = g.device
    order, slots, prob, t_src, t_dst, total = _layout(g, tile_size, None)
    q8 = torch.zeros(total * tile_size * tile_size, dtype=torch.uint8,
                     device=dev)
    qv = quantize_probs(torch.from_numpy(prob[order]).to(dev))
    q8[slots] = qv
    tg = _tiled(g, tile_size, t_src, t_dst, None, None)
    q8 = q8.view(total, tile_size, tile_size)
    keep = qv > 0
    flat = slots[keep]
    _remember((q8, tg.tile_src, tg.tile_dst),
              _slots_from_flat(flat, qv[keep], i32(flat & MASK32), tg,
                               total))
    return tg, q8


# ------------------------------------------------------------- slot lists
# Memo of the slot lists by the identity of the tensors they were built
# from (torch tensors compare elementwise, so never by ==): key the ids,
# value (weak references to check them, the list).  An entry goes when any
# of its tensors is collected.  A stack edited in place after its list was
# built is not supported: the list would keep the old slots.
_SLOT_LISTS: dict[tuple[int, ...], tuple[tuple, SlotList]] = {}


def _remember(tensors: tuple, slots: SlotList) -> SlotList:
    key = tuple(id(t) for t in tensors)
    _SLOT_LISTS[key] = (tuple(weakref.ref(t) for t in tensors), slots)
    for t in tensors:
        weakref.finalize(t, _SLOT_LISTS.pop, key, None)
    return slots


def _recall(tensors: tuple) -> SlotList | None:
    hit = _SLOT_LISTS.get(tuple(id(t) for t in tensors))
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    return None


def _slots_from_flat(flat: torch.Tensor, value: torch.Tensor,
                     key: torch.Tensor, tg: TiledGraph,
                     total: int) -> SlotList:
    """The slot list of the listed slots ``flat`` (int64 indices into the
    raveled ``(total, T, T)`` stack, any order) with their values and int32
    keys, over ``tg``'s tile list."""
    T = tg.tile_size
    T2 = T * T
    tile = flat // T2
    i = flat % T2 // T
    j = flat % T
    order = torch.argsort(tile * T2 + j * T + i)
    tile, i, j = tile[order], i[order], j[order]
    ptr = torch.zeros(total + 1, dtype=torch.int64, device=flat.device)
    ptr[1:] = torch.cumsum(torch.bincount(tile, minlength=total), 0)
    blocks = max(int(tg.tile_src.max()), int(tg.tile_dst.max())) + 1 \
        if total else 0
    return SlotList(
        slot_ptr=ptr.to(torch.int32),
        src_row=(tg.tile_src[tile].to(torch.int64) * T + i).to(torch.int32),
        dst_row=(tg.tile_dst[tile].to(torch.int64) * T + j).to(torch.int32),
        value=value[order], key=key[order],
        src_rows=blocks * T, dst_rows=blocks * T)


def _slots_from_stack(stack: torch.Tensor, tg: TiledGraph,
                      key_of) -> SlotList:
    """The slot list of a contiguous stack read in chunks of tiles of at
    most SLOT_CHUNK slots (no copy of the stack, no ``nonzero`` over more);
    ``key_of(flat)`` gives the int32 keys of the listed flat slots."""
    nt, T, _ = stack.shape
    chunk = max(1, SLOT_CHUNK // (T * T)) * T * T
    flat_stack = stack.view(-1)
    flats = [torch.nonzero(flat_stack[c0:c0 + chunk] > 0).squeeze(1) + c0
             for c0 in range(0, flat_stack.numel(), chunk)]
    flat = torch.cat(flats) if flats else torch.zeros(
        0, dtype=torch.int64, device=stack.device)
    return _slots_from_flat(flat, flat_stack[flat], key_of(flat), tg, nt)


def ic_slot_list_from_stack(tg: TiledGraph) -> SlotList:
    """The slot list of an IC layout read from its stacks (``prob > 0``;
    keys the edge ids), not memoised: `ic_slot_list` is the memo."""
    if tg.prob is None or tg.edge_id is None:
        raise ValueError("fused_expand draws by edge id: build the layout "
                         "with tiles.from_graph(..., edge_ids=True)")
    if tg.prob.shape[0] != tg.num_tiles or tg.edge_id.shape != tg.prob.shape:
        raise ValueError("the prob and edge_id stacks and the tile list "
                         "disagree")
    return _slots_from_stack(tg.prob, tg,
                             lambda flat: tg.edge_id.view(-1)[flat])


def q_slot_list_from_stack(tg: TiledGraph, q8: torch.Tensor) -> SlotList:
    """The slot list of a quantised stack ``q8`` over ``tg``'s tile list
    (``q > 0``; keys the cells), not memoised: `q_slot_list` is the
    memo."""
    if q8.dtype != torch.uint8 or q8.dim() != 3 \
            or q8.shape[0] != tg.num_tiles:
        raise ValueError(f"fused_expand_q reads a (num_tiles, T, T) uint8 "
                         f"stack, got {tuple(q8.shape)} {q8.dtype} for "
                         f"{tg.num_tiles} tiles")
    return _slots_from_stack(q8, tg, lambda flat: i32(flat & MASK32))


def ic_slot_list(tg: TiledGraph) -> SlotList:
    """The slot list of an IC layout, built once per ``(prob, edge_id,
    tile_src, tile_dst)`` tensors (by `from_graph`, or here from the
    stacks)."""
    tensors = (tg.prob, tg.edge_id, tg.tile_src, tg.tile_dst)
    slots = _recall(tensors)
    return slots if slots is not None else _remember(
        tensors, ic_slot_list_from_stack(tg))


def q_slot_list(tg: TiledGraph, q8: torch.Tensor) -> SlotList:
    """The slot list of a quantised stack over ``tg``'s tile list, built
    once per ``(q8, tile_src, tile_dst)`` tensors (by `quantized`, or here
    from the stack)."""
    tensors = (q8, tg.tile_src, tg.tile_dst)
    slots = _recall(tensors)
    return slots if slots is not None else _remember(
        tensors, q_slot_list_from_stack(tg, q8))


def lt_slot_list_from_stack(tg: TiledGraph, cb: torch.Tensor) -> SlotList:
    """The LT slot list of ``tg``'s prob stack and the cb stack beside it
    (``prob > 0``; values the probabilities, keys the float32 bits of
    ``cb``), not memoised: `lt_slot_list` is the memo."""
    if tg.prob is None:
        raise ValueError("lt_select_expand reads the float32 prob stack, "
                         "which a quantised layout (tiles.quantized) lacks")
    if cb.dtype != torch.float32 or cb.shape != tg.prob.shape \
            or tg.prob.shape[0] != tg.num_tiles:
        raise ValueError(f"lt_select_expand: the cb stack "
                         f"{tuple(cb.shape)} {cb.dtype} must be float32 of "
                         f"prob's shape {tuple(tg.prob.shape)}")
    return _slots_from_stack(
        tg.prob, tg, lambda flat: cb.reshape(-1)[flat].view(torch.int32))


def lt_slot_list(tg: TiledGraph, cb: torch.Tensor) -> SlotList:
    """The slot list of an LT layout and its cb stack, built once per
    ``(prob, cb, tile_src, tile_dst)`` tensors (by `lt_cb_tiles`, or here
    from the stacks)."""
    tensors = (tg.prob, cb, tg.tile_src, tg.tile_dst)
    slots = _recall(tensors)
    return slots if slots is not None else _remember(
        tensors, lt_slot_list_from_stack(tg, cb))


def cached(g: Graph, tile_size: int = TILE,
           edge_ids: bool = True) -> TiledGraph:
    """``from_graph(g, tile_size, edge_ids=edge_ids)`` built once per graph
    object — samplers over one graph share the device stacks instead of
    each holding a copy."""
    key = ("tiles", tile_size, edge_ids)
    tg = g.cache.get(key)
    if tg is None:
        tg = g.cache[key] = from_graph(g, tile_size, edge_ids=edge_ids)
    return tg


def lt_cb_tiles(tg: TiledGraph, g: Graph, cum_before) -> torch.Tensor:
    """Per-CSR-edge float32 ``cum_before`` of ``g`` (the selection-CDF
    prefixes of `core.lt.selection_cum_before`) in the ``(nt, T, T)``
    layout ``tg = from_graph(g, ...)``, on ``tg``'s device: the LT cb
    stack, with its slot list (`lt_slot_list`) built from the same arrays.
    Scattered through `edge_slot_map`, as ``from_graph`` scatters ``prob``;
    slots whose ``prob`` is not > 0 hold 0, as in the reference's
    ``edge_values_to_tiles`` (its default ``fill``), which gathers by
    ``edge_id`` and masks on ``prob``."""
    if tg.prob is None:
        raise ValueError("an LT layout needs the float32 prob stack, which "
                         "a quantised layout (tiles.quantized) lacks")
    dev = tg.device
    prob = tg.prob.view(-1)
    cb = torch.zeros(prob.numel(), dtype=torch.float32, device=dev)
    slot = torch.from_numpy(edge_slot_map(g, tg.tile_size)[0]).to(dev)
    vals = torch.as_tensor(np.asarray(cum_before, np.float32)[:g.num_edges],
                           device=dev)
    keep = prob[slot] > 0
    flat = slot[keep]
    cb[flat] = vals[keep]
    cb = cb.view(tg.prob.shape)
    _remember((tg.prob, cb, tg.tile_src, tg.tile_dst),
              _slots_from_flat(flat, prob[flat],
                               vals[keep].view(torch.int32), tg,
                               tg.num_tiles))
    return cb


def active_tile_ids(tile_src: torch.Tensor,
                    active_blocks: torch.Tensor) -> torch.Tensor:
    """(count,) int32 ascending ids of the tiles whose SOURCE block is
    active — the reference's compaction without its null-tile padding (the
    port's kernels walk an exact-length list, so nothing needs a fill
    target).  A dst-sorted layout stays dst-sorted along the list."""
    return torch.nonzero(active_blocks[tile_src.to(torch.int64)]) \
        .squeeze(1).to(torch.int32)


def tile_stats(tg: TiledGraph) -> dict:
    """Reordering benchmark metrics (the paper's Fig. 5 analogue)."""
    nblocks = tg.num_blocks
    return dict(
        num_tiles=tg.num_tiles,
        possible_tiles=nblocks * nblocks,
        tile_fill_fraction=tg.num_tiles / max(nblocks * nblocks, 1),
        occupancy=tg.occupancy,
    )


def pad_mask_rows(mask: torch.Tensor, padded_vertices: int) -> torch.Tensor:
    pad = padded_vertices - mask.shape[0]
    return F.pad(mask, (0, 0, 0, pad)) if pad else mask
