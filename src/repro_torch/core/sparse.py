"""Sparse-frontier traversal engine: active-block compaction over edge
blocks (PyTorch port of ``repro.core.sparse``).

Once per graph, on the host, the reversed graph's edges are grouped by
source row-block (``tile_rows`` rows per block) into fixed-size edge blocks
(`FrontierIndex`).  Per level, the active row-blocks come from the packed
frontier, the ids of their edge blocks are compacted, and only those
blocks' edges are gathered, gated (the IC Bernoulli draw or the LT
live-edge test) and scattered: per-level work follows the live frontier,
not E.

The reference compacts into static capacity buffers on a ladder of
buckets (`bucket_ladder`), because a traced program needs static shapes.
The port runs eagerly, so it gathers exactly the active blocks and keeps
the ladder for accounting: ``grid_steps`` records, per level, the smallest
rung that holds the active count (`ladder_rung`, the reference's
``cond_ladder`` choice), so every `TraversalStats` field equals the
reference's; the exact count is reported beside it.

Bit-identity with the dense sweep is structural: the RNG is keyed by CSR
edge id (IC) or destination vertex (LT), so a gathered edge draws what the
dense sweep draws, and a skipped edge has no active source colour.  The
work counters count valid slots of gathered blocks — CSR padding edges
included, as the dense sweep counts them — so they agree exactly too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bitmask, rng
from repro_torch.core.traversal import (TraversalResult, _active_tiles,
                                        _scatter_or, _word_lanes,
                                        init_frontier, level_stats)
from repro_torch.graph.csr import Graph


@dataclasses.dataclass(frozen=True)
class FrontierIndex:
    """Edge blocks grouped by source row-block, on the graph's device.

    Per-edge arrays are ``(NB, EB)``: the reference's layout without its
    trailing null block, which only its fixed-capacity gathers read.
    ``blk_valid`` marks real CSR slots (CSR padding edges included — the
    dense sweep counts them); ``blk_rowblock`` is each block's source
    row-block, the key the per-level compaction reads.
    """
    blk_src: torch.Tensor        # (NB, EB) int32   edge source vertex
    blk_dst: torch.Tensor        # (NB, EB) int32   edge destination vertex
    blk_prob: torch.Tensor       # (NB, EB) float32 IC prob / LT in-weight
    blk_eid: torch.Tensor        # (NB, EB) int32   CSR edge id (RNG counter)
    blk_valid: torch.Tensor      # (NB, EB) bool
    blk_cb: torch.Tensor | None  # (NB, EB) float32 LT selection-CDF prefix
    blk_rowblock: torch.Tensor   # (NB,) int32 source row-block per block
    num_vertices: int
    num_blocks: int
    edge_block: int
    tile_rows: int

    @property
    def num_row_blocks(self) -> int:
        return -(-self.num_vertices // self.tile_rows)


def build_frontier_index(g_rev: Graph, tile_rows: int = 128,
                         edge_block: int = 128,
                         cb: np.ndarray | None = None) -> FrontierIndex:
    """Group the reversed graph's edges by source row-block (host numpy, the
    reference's construction).  Every CSR slot rides along, prob-0 padding
    edges included; ``cb`` attaches the LT selection-CDF prefixes
    (`lt.selection_cum_before`) in the same block layout."""
    e_pad = g_rev.padded_edges
    src = g_rev.src.cpu().numpy()
    dst = g_rev.dst.cpu().numpy()
    prob = g_rev.prob.cpu().numpy()
    cb = None if cb is None else np.asarray(cb, np.float32)[:e_pad]

    rb = src // tile_rows
    order = np.argsort(rb, kind="stable")
    nrb = -(-g_rev.num_vertices // tile_rows)
    counts = np.bincount(rb, minlength=nrb)
    blocks_per = -(-counts // edge_block)          # 0 for empty row-blocks
    nb = int(blocks_per.sum())
    # Block k of row-block r holds that row-block's sorted edges
    # [k·EB, (k+1)·EB); each edge's flat slot follows from its rank.
    first_blk = np.concatenate([[0], np.cumsum(blocks_per)[:-1]])
    first_edge = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rb_sorted = rb[order]
    rank = np.arange(e_pad) - first_edge[rb_sorted]
    flat = first_blk[rb_sorted] * edge_block + rank

    def place(values, dtype, fill=0):
        out = np.full(nb * edge_block, fill, dtype)
        out[flat] = values[order]
        return torch.from_numpy(out.reshape(nb, edge_block)).to(g_rev.device)

    return FrontierIndex(
        blk_src=place(src, np.int32), blk_dst=place(dst, np.int32),
        blk_prob=place(prob, np.float32),
        blk_eid=place(np.arange(e_pad, dtype=np.int32), np.int32),
        blk_valid=place(np.ones(e_pad, bool), bool, False),
        blk_cb=None if cb is None else place(cb, np.float32),
        blk_rowblock=torch.from_numpy(
            np.repeat(np.arange(nrb, dtype=np.int32), blocks_per)).to(
                g_rev.device),
        num_vertices=g_rev.num_vertices, num_blocks=nb,
        edge_block=edge_block, tile_rows=tile_rows)


def patch_frontier_index(fidx: FrontierIndex, g_rev: Graph,
                         touched_row_blocks,
                         cb: np.ndarray | None = None) -> FrontierIndex:
    """Re-derive only the edge blocks of ``touched_row_blocks`` from a
    values-mutated graph, IN PLACE, and return ``fidx`` — the
    churn-priced alternative to a full rebuild after a streaming delta.

    Precondition (the caller's to check — `Sampler.rebind` compares the
    edge arrays): ``g_rev`` has the ``(src, dst)`` layout and padded length
    of the graph ``fidx`` was built from, so block membership, edge ids
    and validity are unchanged and the patch is a gather: for every
    selected block ``prob = where(valid, g_rev.prob[eid], 0)``, as
    `build_frontier_index` writes it, and the same for the LT prefixes
    ``cb`` when the index carries them.  Only the sampler that owns
    ``fidx`` may call this (each sampler builds its own index)."""
    if (fidx.blk_cb is None) != (cb is None):
        raise ValueError("cb must be given iff the index carries blk_cb")
    dev = fidx.blk_prob.device
    rb = torch.as_tensor(np.asarray(touched_row_blocks, np.int64),
                         device=dev)
    ids = torch.nonzero(torch.isin(fidx.blk_rowblock.to(torch.int64), rb)) \
        .squeeze(1)
    if not ids.numel():
        return fidx
    eid = fidx.blk_eid[ids].to(torch.int64)
    valid = fidx.blk_valid[ids]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fidx.blk_prob[ids] = torch.where(valid, g_rev.prob.to(dev)[eid], zero)
    if cb is not None:
        cbt = torch.as_tensor(np.asarray(cb, np.float32), device=dev)
        fidx.blk_cb[ids] = torch.where(valid, cbt[eid], zero)
    return fidx


def bucket_ladder(num_blocks: int, capacity: int = 0) -> tuple[int, ...]:
    """The reference's capacity buckets: the top rung is ``num_blocks``;
    ``capacity = 0`` gives the geometric ladder 8, 64, 512, …, an explicit
    ``capacity`` the two rungs {pow2(capacity), num_blocks}."""
    n = max(int(num_blocks), 1)
    if capacity and capacity > 0:
        top = 1
        while top < min(capacity, n):
            top *= 2
        rungs = {min(top, n), n}
    else:
        rungs = {n}
        r = 8
        while r < n:
            rungs.add(r)
            r *= 8
    return tuple(sorted(rungs))


def ladder_rung(count: int, ladder: tuple[int, ...]) -> int:
    """The rung the reference's ``cond_ladder`` runs for ``count``: the
    smallest with ``count ≤ rung``, else the last."""
    return next((k for k in ladder if count <= k), ladder[-1])


def row_block_activity(frontier: torch.Tensor,
                       tile_rows: int) -> torch.Tensor:
    """(n_row_blocks,) bool — row blocks holding ≥ 1 active vertex."""
    act = (frontier != 0).any(1)
    act = F.pad(act, (0, (-frontier.shape[0]) % tile_rows))
    return act.view(-1, tile_rows).any(1)


def _sparse_step(fidx: FrontierIndex, frontier, visited, level: int, seed,
                 ladder: tuple[int, ...], u=None):
    """One compacted level; ``visited`` already includes ``frontier``.
    Returns ``(next_frontier, info)``: ``info`` holds the device int32
    visit counters (bit-equal to the dense sweep's), and the host ints
    ``active_blocks`` and ``grid_steps`` (its ladder rung).

    ``u = None`` selects the IC per-(edge, colour, level) Bernoulli gate; a
    (V, W·32) LT uniform table (`kernels.ref.lt_selection_uniforms`) the
    fixed live-edge gate.
    """
    w = frontier.shape[1]
    act = row_block_activity(frontier, fidx.tile_rows)
    ids = torch.nonzero(act[fidx.blk_rowblock.to(torch.int64)]).squeeze(1)
    count = int(ids.numel())
    s = fidx.blk_src[ids].reshape(-1).to(torch.int64)
    d = fidx.blk_dst[ids].reshape(-1).to(torch.int64)
    valid = fidx.blk_valid[ids].reshape(-1)
    fr_src = frontier[s]                                 # (K·EB, W)
    live = torch.nonzero((fr_src != 0).any(1)).squeeze(1)
    p = fidx.blk_prob[ids].reshape(-1)[live]
    d_live = d[live]
    if u is None:
        eid = fidx.blk_eid[ids].reshape(-1)[live]
        bits = rng.hash_u32(seed, level, eid[:, None, None],
                            _word_lanes(w, frontier.device)[None])
        gate = rng.uniform_from_u32(bits) < p[:, None, None]
    else:
        lo = fidx.blk_cb[ids].reshape(-1)[live][:, None, None]
        hi = lo + p[:, None, None]
        U = u[d_live].view(-1, w, 32)
        gate = (U >= lo) & (U < hi)
    contrib = fr_src[live] & bitmask.pack_bits(gate) & ~visited[d_live]
    nf = _scatter_or(torch.zeros_like(visited), d_live, contrib) & ~visited
    active_src = bitmask.count_colors(fr_src)
    info = dict(
        fused_visits=((active_src > 0) & valid).sum(dtype=torch.int32),
        unfused_visits=torch.where(valid, active_src, 0).sum(
            dtype=torch.int32),
        active_blocks=count, grid_steps=ladder_rung(count, ladder))
    return nf, info


def run_fused_sparse(fidx: FrontierIndex, starts, num_colors: int, seed,
                     max_levels: int = 64,
                     ladder: tuple[int, ...] | None = None
                     ) -> TraversalResult:
    """`traversal.run_fused` on the sparse engine — the visited mask AND
    every `TraversalStats` field bit-equal to the reference's."""
    if ladder is None:
        ladder = bucket_ladder(fidx.num_blocks)
    dev = fidx.blk_src.device
    frontier = init_frontier(fidx.num_vertices, num_colors, starts, dev)
    visited = torch.zeros_like(frontier)
    rows, rungs = [], []
    level = 0
    while level < max_levels and bitmask.any_set(frontier):
        act_tiles = _active_tiles(frontier)
        per_row = bitmask.count_colors(frontier)
        visited |= frontier                              # Listing 1 line 8
        nf, info = _sparse_step(fidx, frontier, visited, level, seed, ladder)
        rows.append(torch.stack([info["fused_visits"],
                                 info["unfused_visits"],
                                 (per_row > 0).sum(dtype=torch.int32),
                                 per_row.sum(dtype=torch.int32), act_tiles]))
        rungs.append(info["grid_steps"])
        frontier = nf
        level += 1
    stats = level_stats(rows, level, max_levels, fidx.num_vertices,
                        num_colors, grid_steps=rungs)
    return TraversalResult(visited=visited | frontier, stats=stats)


def run_fused_lt_sparse(fidx: FrontierIndex, starts, num_colors: int, seed,
                        max_levels: int = 64,
                        ladder: tuple[int, ...] | None = None
                        ) -> torch.Tensor:
    """`lt.run_fused_lt` on the sparse engine (visited (V, W)): the live-edge
    test runs per gathered edge on the traversal's uniform table, without
    the (E, W) selection mask."""
    from repro_torch.kernels import ref as kref

    if ladder is None:
        ladder = bucket_ladder(fidx.num_blocks)
    if fidx.blk_cb is None:
        raise ValueError("LT needs a FrontierIndex built with cb="
                         "lt.selection_cum_before(g_rev)")
    dev = fidx.blk_src.device
    u = kref.lt_selection_uniforms(seed, fidx.num_vertices, num_colors,
                                   device=dev)
    frontier = init_frontier(fidx.num_vertices, num_colors, starts, dev)
    visited = torch.zeros_like(frontier)
    level = 0
    while level < max_levels and bitmask.any_set(frontier):
        visited |= frontier
        frontier, _ = _sparse_step(fidx, frontier, visited, level, seed,
                                   ladder, u=u)
        level += 1
    return visited | frontier


def sparse_block(fidx: FrontierIndex, starts, seeds, num_colors: int,
                 max_levels: int, ladder: tuple[int, ...],
                 diffusion: str = "ic"):
    """A block of batches on the sparse engine: starts (B, C), seeds (B,) →
    (visited (B, V, W), fused (B,), unfused (B,)); LT carries the -1 "not
    instrumented" sentinel."""
    vis, fused, unfused = [], [], []
    for st, sd in zip(starts, seeds):
        if diffusion == "lt":
            vis.append(run_fused_lt_sparse(fidx, st, num_colors, int(sd),
                                           max_levels, ladder))
            fused.append(-1)
            unfused.append(-1)
            continue
        res = run_fused_sparse(fidx, st, num_colors, int(sd), max_levels,
                               ladder)
        vis.append(res.visited)
        fused.append(res.stats.fused_edge_visits.sum())
        unfused.append(res.stats.unfused_edge_visits.sum())
    return torch.stack(vis), np.asarray(fused), np.asarray(unfused)


def profile_traversal(fidx: FrontierIndex, starts, num_colors: int, seed,
                      max_levels: int = 64,
                      ladder: tuple[int, ...] | None = None,
                      diffusion: str = "ic") -> list[dict]:
    """Per level: the active row-block and edge-block counts, the ladder
    bucket, and the work counters — from the same `_sparse_step` the
    traversals run."""
    from repro_torch.kernels import ref as kref

    if ladder is None:
        ladder = bucket_ladder(fidx.num_blocks)
    dev = fidx.blk_src.device
    u = (kref.lt_selection_uniforms(seed, fidx.num_vertices, num_colors,
                                    device=dev)
         if diffusion == "lt" else None)
    fr = init_frontier(fidx.num_vertices, num_colors, starts, dev)
    vis = torch.zeros_like(fr)
    out = []
    level = 0
    while level < max_levels and bitmask.any_set(fr):
        act_rows = int(row_block_activity(fr, fidx.tile_rows).sum())
        vis = vis | fr
        fr, info = _sparse_step(fidx, fr, vis, level, seed, ladder, u=u)
        out.append(dict(
            level=level,
            active_row_blocks=act_rows,
            active_edge_blocks=info["active_blocks"],
            bucket=info["grid_steps"],
            fused_edge_visits=int(info["fused_visits"]),
            unfused_edge_visits=int(info["unfused_visits"]),
        ))
        level += 1
    return out
