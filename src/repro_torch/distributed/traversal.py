"""Distributed fused-BPT traversal (PyTorch port of
``repro.distributed.traversal``), SPMD over a `distributed.comm.Mesh`.

Two axes, composable on one mesh:

* **Sample parallelism** (the paper's multi-node axis, Fig. 10):
  independent fused batches split over ``data``; no collective during a
  traversal, one reduction per greedy pick (`distributed_greedy_max_cover`).
* **Graph parallelism**: the destination rows split over ``model``
  (`graph.partition`).  Each level exchanges the frontier over ``model``
  and expands only the shard's own tiles, through the tile kernels
  (`kernels.ops.fused_expand_slots` for IC, ``lt_select_expand_slots`` for
  LT) on the shard's slot list: the global ``(Vp, W)`` frontier in, the
  shard's ``(rows, W)`` visited rows out.  The kernel runs on a CUDA
  tensor and its plain version on a CPU one, as everywhere in the port.

Every rank calls these functions with the same arguments in the same
order.  Each computes its own block (its batch slice, its row slice) and
returns it; `distributed.comm.Mesh.all_gather` assembles blocks.  The
expansion math is the single-device one (edge-id-keyed IC draws, LT
selection from global destination ids), so every mask is bit-identical to
a single-device run.

Lockstep.  A level loop's control decisions — keep going, sparse or dense
leg — reduce over ``sync_axes`` (data and model in `graph_parallel_block`),
so every rank steps levels together and runs the same collectives: a rank
that stopped early would leave its peers waiting in a collective until the
group's timeout.  A rank whose frontier drained exchanges zeros until the
slowest peer ends; ``gather_words`` records that traffic, as the
reference's does.  Blocks are padded to the data-axis size by the callers,
so every rank runs the same number of traversals.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitmask, tiles, traversal
from repro_torch.core.traversal import init_frontier
from repro_torch.distributed.comm import Mesh
from repro_torch.graph import csr
from repro_torch.graph.partition import ShardLayout
from repro_torch.kernels import ops, ref


# ------------------------------------------------------------ sample parallel
def run_batch(g: csr.Graph, starts, seed: int, num_colors: int,
              max_levels: int = 64) -> torch.Tensor:
    """One fused batch's ``(V, W)`` visited mask by the CSR sweep — the
    unit sample parallelism splits."""
    return traversal.run_fused(g, starts, num_colors, int(seed),
                               max_levels).visited


def _data_slice(mesh: Mesh, axes, total: int) -> slice:
    """This rank's contiguous block of ``total`` items split over
    ``axes`` (row-major over the named axes)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    shards, pos = 1, 0
    for ax in axes:
        shards *= mesh.axis_size(ax)
        pos = pos * mesh.axis_size(ax) + mesh.axis_index(ax)
    if total % shards:
        raise ValueError(f"{total} items do not split over {shards} shards "
                         f"of {axes} (callers pad the block)")
    per = total // shards
    return slice(pos * per, (pos + 1) * per)


def sample_parallel_visited(g: csr.Graph, all_starts, batch_seeds,
                            num_colors: int, mesh: Mesh, axes=("data",),
                            max_levels: int = 64) -> torch.Tensor:
    """Run B independent fused batches split over ``axes``: all_starts
    (B, C), batch_seeds (B,), B a multiple of the shard count.  Returns
    this rank's ``(B/shards, V, W)`` block of visited masks."""
    sl = _data_slice(mesh, axes, len(batch_seeds))
    starts = np.asarray(all_starts)[sl]
    seeds = np.asarray(batch_seeds)[sl]
    return torch.stack([run_batch(g, st, int(sd), num_colors, max_levels)
                        for st, sd in zip(starts, seeds)])


def distributed_greedy_max_cover(visited: torch.Tensor, k: int,
                                 num_colors: int, mesh: Mesh,
                                 axes=("data",)):
    """Greedy max-k-cover over an RRR collection split over batches:
    ``visited`` is this rank's ``(B_loc, V, W)`` block.  Each pick counts
    the rank's block with `kernels.ops.cover_counts`, one psum over
    ``axes`` merges the counts, and every rank takes the same argmax
    (first index on ties).  Returns (seeds (k,) int32, covered fraction)."""
    b, _, w = visited.shape
    active = bitmask.tail_mask_tensor(num_colors, visited.device) \
        .expand(b, w).contiguous()
    seeds = []
    for _ in range(k):
        counts = mesh.psum(ops.cover_counts(visited, active), axes)
        sel = int(torch.argmax(counts))
        seeds.append(sel)
        active = active & ~visited[:, sel, :]
    theta = mesh.psum(torch.tensor([b], dtype=torch.int64), axes)
    uncovered = mesh.psum(
        bitmask.popcount(active).sum(dtype=torch.int64).reshape(1), axes)
    theta = int(theta) * num_colors
    return np.asarray(seeds, np.int32), (theta - int(uncovered)) / theta


# ------------------------------------------------------------- graph parallel
def gather_capacity_words(rows: int, num_words: int, capacity: int = 0) -> int:
    """Per-shard capacity (packed words) of the sparse frontier exchange.

    ``capacity = 0`` (auto) budgets an eighth of the shard's ``rows × W``
    words, rounded up to a power of two: levels above it (the dense early
    levels) take the full all-gather, levels below it (the collapsed tail)
    ship only their active words."""
    n = rows * num_words
    want = capacity if capacity > 0 else max(n // 8, 1)
    k = 1
    while k < min(want, n):
        k *= 2
    return min(k, n)


def _frontier_gather_loop(expand, frontier_local: torch.Tensor,
                          max_levels: int, mesh: Mesh, axis: str,
                          num_shards: int = 1, sparse_words: int = 0,
                          sync_axes: tuple = ()):
    """THE graph-parallel level loop: per-level frontier exchange over
    ``axis``, local expansion, termination agreed over ``sync_axes``
    (default ``(axis,)``).  ``expand(fr_global (Vp, W), vis_local
    (rows, W), level)`` returns the new local frontier.

    Returns ``(visited_local, levels, gather_words)``: ``gather_words`` is
    a ``(max_levels,)`` int64 array of the packed words each level moved
    over ``axis`` by the reference's accounting, summed over the shards
    (zero past the last level): ``S(S−1)·rows·W`` on a dense level, on a
    sparse one ``2·count + S + 1`` per butterfly stage and shard.

    ``sparse_words > 0`` arms the sparse leg: when the largest active word
    count over ``sync_axes`` fits, shards exchange ``(word index, word)``
    pairs in ``⌈log₂ S⌉`` `_butterfly_exchange` stages instead of the
    all-gather.  One pmax over ``sync_axes`` per level carries both the
    termination test and that count, so every rank takes the same branch.
    Either leg rebuilds the exact global frontier."""
    sync = sync_axes or (axis,)
    gather_words = np.zeros(max_levels, np.int64)
    fr = frontier_local
    vis = torch.zeros_like(fr)
    lvl = 0
    while lvl < max_levels:
        most = int(level_control(fr, mesh, sync))
        if most == 0:
            break
        fr, vis, gather_words[lvl] = gather_level(
            expand, fr, vis, lvl, mesh, axis, num_shards, sparse_words, most)
        lvl += 1
    return vis | fr, lvl, gather_words


def level_control(fr: torch.Tensor, mesh: Mesh, sync) -> torch.Tensor:
    """A level's control: the most nonzero frontier words of any rank over
    ``sync`` (one pmax); 0 ends the loop."""
    nz = torch.count_nonzero(fr).to(torch.int64).reshape(1)
    return mesh.pmax(nz, sync)


def gather_level(expand, fr: torch.Tensor, vis: torch.Tensor, lvl: int,
                 mesh: Mesh, axis: str, num_shards: int,
                 sparse_words: int = 0, most: int = 0):
    """One level of `_frontier_gather_loop` past its control (``most``,
    `level_control`'s count): the frontier's exchange over ``axis`` and
    the shard's expansion.  Returns (new local frontier, visited, words
    moved)."""
    rows, num_words = fr.shape
    n, s = rows * num_words, num_shards
    vis = vis | fr
    if sparse_words and sparse_words < n and most <= sparse_words:
        buf_i, buf_w, sent = _butterfly_exchange(fr, mesh, axis, s, n)
        fr_global = _scatter_pairs(buf_i, buf_w, rows, num_words, s)
        words = int(mesh.psum(torch.tensor([sent], dtype=torch.int64),
                              axis))
    else:
        fr_global = mesh.all_gather(fr, axis)
        words = s * (s - 1) * n
    return expand(fr_global, vis, lvl), vis, words


def _scatter_pairs(buf_i: torch.Tensor, buf_w: torch.Tensor, rows: int,
                   num_words: int, num_shards: int) -> torch.Tensor:
    """The ``(S·rows, W)`` global frontier from the exchanged
    ``(global word index, word)`` pairs.  Each global index comes from one
    shard and the block dedup delivers it once, so the indices are
    distinct: the packed ``unique`` scatter is exact."""
    full = torch.zeros(num_shards * rows, num_words, dtype=torch.int32,
                       device=buf_w.device)
    return bitmask.scatter_or_words(full, buf_i // num_words,
                                    buf_i % num_words, buf_w, unique=True)


def _butterfly_exchange(fr: torch.Tensor, mesh: Mesh, axis: str,
                        num_shards: int, n: int):
    """ButterFly-BFS-style dissemination all-gather of the compacted
    frontier (arXiv 2103.13577): ``⌈log₂ S⌉`` pairwise `Mesh.ppermute`
    stages instead of one flat all-gather.

    Stage ``t`` sends the whole accumulated pair set to shard
    ``(i − 2ᵗ) mod S`` and receives from ``(i + 2ᵗ) mod S``; afterwards a
    shard holds the pairs of source shards ``[i, i + 2ᵗ⁺¹) mod S``, so the
    stages cover any S.  A ``have`` vector of the source shards held drops
    a re-delivered block (a non-power-of-two S overlaps on the last
    stage).  Each stage ships its ``S + 1`` words of metadata (the pair
    count and ``have``) first, then only the real pairs.

    Returns ``(idx (m,) int64 global word indices, words (m,) int32,
    sent)``: ``sent`` is the reference's count of the words this shard
    shipped, ``2·count + S + 1`` per stage (its buffers are padded to a
    static capacity; the count is what they carry)."""
    s = num_shards
    flat = fr.reshape(-1)
    idx = torch.nonzero(flat).squeeze(1)
    me = mesh.axis_index(axis)
    buf_i = idx + me * n
    buf_w = flat[idx]
    have = torch.zeros(s, dtype=torch.int64, device=fr.device)
    have[me] = 1
    sent = 0
    shift = 1
    while shift < s:
        count = buf_i.numel()
        meta = torch.cat([torch.tensor([count], device=fr.device), have])
        r_meta = mesh.ppermute(meta, axis, shift)
        r_count = int(r_meta[0])
        payload = torch.stack([buf_i, buf_w.to(torch.int64)])
        r_pay = mesh.ppermute(payload, axis, shift, recv_shape=(2, r_count))
        sent += 2 * count + s + 1
        r_i, r_w = r_pay[0], r_pay[1].to(torch.int32)
        keep = have[r_i // n] == 0
        buf_i = torch.cat([buf_i, r_i[keep]])
        buf_w = torch.cat([buf_w, r_w[keep]])
        have = torch.maximum(have, r_meta[1:])
        shift *= 2
    return buf_i, buf_w, sent


def _local_expand(slots: tiles.SlotList, layout: ShardLayout,
                  diffusion: str, seed: int, num_colors: int):
    """Per-shard expansion over the shard's slot list: IC draws per (edge,
    colour, level) keyed by the CSR edge id; LT tests the fixed live-edge
    selection on a uniform table of the shard's rows, built once here from
    global destination ids (``row_base``) and reused by every level."""
    if diffusion == "lt":
        u = ref.lt_selection_uniforms(seed, layout.rows, num_colors,
                                      row_base=layout.row_base,
                                      device=slots.src_row.device)

        def expand(fr_global, vis_local, level):
            return ops.lt_select_expand_slots(slots, fr_global, vis_local, u)
    else:
        def expand(fr_global, vis_local, level):
            return ops.fused_expand_slots(slots, fr_global, vis_local, seed,
                                          level)
    return expand


def _local_frontier(layout: ShardLayout, num_colors: int, starts,
                    device) -> torch.Tensor:
    """The shard's ``(rows, W)`` rows of a batch's initial frontier."""
    fr = tiles.pad_mask_rows(
        init_frontier(layout.num_vertices, num_colors, starts, device),
        layout.padded_vertices)
    return fr[layout.row_base:layout.row_base + layout.rows]


def graph_parallel_traversal(layout: ShardLayout, slots: tiles.SlotList,
                             starts, num_colors: int, seed: int, mesh: Mesh,
                             axis: str = "model", max_levels: int = 64):
    """Fused IC BPT with the graph's rows split over ``axis``: ``layout``
    and ``slots`` are this rank's shard (`graph.partition.shard_layout`,
    ``layout.slot_list(prob, edge ids)``).  Returns (this rank's visited
    rows (rows, W), levels)."""
    fr = _local_frontier(layout, num_colors, starts, slots.src_row.device)
    expand = _local_expand(slots, layout, "ic", int(seed), num_colors)
    vis, levels, _ = _frontier_gather_loop(expand, fr, max_levels, mesh,
                                           axis, layout.num_shards)
    return vis, levels


def graph_parallel_block(layout: ShardLayout, slots: tiles.SlotList,
                         mesh: Mesh, starts, seeds, *,
                         data_axis: str = "data", model_axis: str = "model",
                         num_colors: int, max_levels: int = 64,
                         diffusion: str = "ic", frontier: str = "dense",
                         gather_capacity: int = 0):
    """The 2-D (data × model) block behind the ``graph_parallel`` sampler:
    a block of B batches (``starts`` (B, C), ``seeds`` (B,), B a multiple
    of the data-axis size; every rank passes the whole block) split over
    ``data_axis``, the graph's rows over ``model_axis``.  Each rank
    traverses its batch slice one after another on its row slice; the
    frontier exchange names the model axis only, the level loop's control
    reduces over both.  ``frontier="sparse"`` arms the sparse exchange leg
    (``gather_capacity`` words a shard, `gather_capacity_words`).

    Returns this rank's ``(visited (B/D, rows, W), gather_words
    (B/D, max_levels))``."""
    if diffusion not in ("ic", "lt") or frontier not in ("dense", "sparse"):
        raise ValueError(f"diffusion {diffusion!r} / frontier {frontier!r}")
    dev = slots.src_row.device
    sparse_words = (gather_capacity_words(
        layout.rows, bitmask.num_words(num_colors), gather_capacity)
        if frontier == "sparse" else 0)
    sl = _data_slice(mesh, data_axis, len(seeds))
    vis, words = [], []
    for st, sd in zip(np.asarray(starts)[sl], np.asarray(seeds)[sl]):
        fr = _local_frontier(layout, num_colors, st, dev)
        expand = _local_expand(slots, layout, diffusion, int(sd), num_colors)
        v, _, gw = _frontier_gather_loop(
            expand, fr, max_levels, mesh, model_axis, layout.num_shards,
            sparse_words, sync_axes=(data_axis, model_axis))
        vis.append(v)
        words.append(gw)
    w = bitmask.num_words(num_colors)
    visited = torch.stack(vis) if vis else torch.zeros(
        (0, layout.rows, w), dtype=torch.int32, device=dev)
    return visited, np.asarray(words, np.int64).reshape(-1, max_levels)
