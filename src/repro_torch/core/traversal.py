"""Fused breadth-first probabilistic traversals, CSR edge-centric sweep
(PyTorch port of ``repro.core.traversal``).

One level over packed ``(V, W)`` colour masks:

    visited'  = visited | frontier                         (Listing 1 l. 8)
    contrib[e] = frontier[src[e]] & bernoulli(prob[e]) & ~visited'[dst[e]]
    frontier' = scatter_or(dst, contrib) & ~visited'

This is the ``dense`` sampler backend and the independent cross-check of
the tile path: it never touches the tile layout or the CUDA kernels, only
the shared counter RNG.  Only edges whose source carries a colour are
hashed — the others contribute 0 — and the loop is a Python ``while`` with
one host sync per level for the frontier test.  ``run_single_color`` and
``run_unfused`` are the unfused baseline on the same counters, so colour
``c`` of a fused run equals the single-colour run of ``c`` bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitmask, rng, threefry
from repro_torch.graph.csr import Graph

_TILE_ROWS = 128       # row-tile height of the active_tile_frac statistic
_HASH_CHUNK = 2 ** 28  # (edge, word, lane) counters hashed at once


@dataclasses.dataclass(frozen=True)
class TraversalStats:
    """Per-level instrumentation, host numpy, sized ``max_levels``."""
    levels_run: int
    # The fused algorithm visits edge e at level t iff any colour is active
    # at src[e]; the unfused equivalent visits it once per active colour.
    fused_edge_visits: np.ndarray      # (max_levels,) int32
    unfused_edge_visits: np.ndarray    # (max_levels,) int32
    frontier_vertices: np.ndarray      # (max_levels,) int32  active vertices
    frontier_colors: np.ndarray        # (max_levels,) int32  Σ popcount
    occupancy_num: np.ndarray          # (max_levels,) f32  Σ popcount / active
    active_tile_frac: np.ndarray       # (max_levels,) f32  128-row tiles live
    grid_steps: np.ndarray             # (max_levels,) int32  (CSR: 0)


@dataclasses.dataclass(frozen=True)
class TraversalResult:
    visited: torch.Tensor              # (V, W) int32 — column c is RRR set c
    stats: TraversalStats


def init_frontier(num_vertices: int, num_colors: int, starts,
                  device) -> torch.Tensor:
    """(V, W) frontier with bit ``c`` set at row ``starts[c]`` (several
    colours may share a start vertex)."""
    colors = torch.arange(num_colors, device=device)
    frontier = bitmask.make_mask(num_vertices, num_colors, device)
    starts = torch.from_numpy(np.array(starts, np.int64)).to(device)
    return bitmask.set_color(frontier, starts, colors)


def random_starts(seed: int, num_vertices: int, num_colors: int,
                  sort: bool = False) -> np.ndarray:
    """Uniform-random start vertices — ``jax.random.randint`` under
    ``jax.random.key(seed)`` (`core.threefry`).  ``sort=True`` pre-sorts
    them for locality (paper §5 'sorted variant')."""
    starts = threefry.randint(threefry.key(seed), num_colors, 0, num_vertices)
    return np.sort(starts) if sort else starts


def _scatter_or(base_words: torch.Tensor, dst: torch.Tensor,
                contrib: torch.Tensor) -> torch.Tensor:
    """base[dst] |= contrib with duplicate destinations ORed together."""
    w = base_words.shape[1]
    rows = dst.to(torch.int64)[:, None].expand(-1, w)
    words = torch.arange(w, device=dst.device)[None, :].expand_as(rows)
    return bitmask.scatter_or_words(base_words, rows, words, contrib)


def _word_lanes(num_words: int, device) -> torch.Tensor:
    """(W, 32) colour ids ``w*32 + lane`` — the RNG's word counter."""
    return (torch.arange(num_words, device=device)[:, None] * 32
            + torch.arange(32, device=device)[None, :])


def _draw_words(g: Graph, live: torch.Tensor, num_words: int, level: int,
                seed: int) -> torch.Tensor:
    """(E_live, W) packed Bernoulli words of the ``live`` edges, hashed
    ``_HASH_CHUNK`` (edge, word, lane) counters at a time: each counter is
    an int64 temporary, so one pass over 10M live edges at W = 2 would
    hold several 5.1 GB arrays at once."""
    lanes = _word_lanes(num_words, live.device)[None]
    words = []
    for e in live.split(max(1, _HASH_CHUNK // (num_words * 32))):
        bits = rng.hash_u32(seed, level, e[:, None, None], lanes)
        draws = rng.uniform_from_u32(bits) < g.prob[e][:, None, None]
        words.append(bitmask.pack_bits(draws))
    return torch.cat(words)


def fused_step(g: Graph, frontier: torch.Tensor, visited: torch.Tensor,
               level: int, seed: int):
    """One level of the fused traversal.  Returns (frontier', visited', info)
    with ``info`` holding device int32 scalars."""
    visited = visited | frontier                            # Listing 1 line 8
    fr_src = frontier[g.src.to(torch.int64)]                # (E, W) gather
    live = torch.nonzero((fr_src != 0).any(1)).squeeze(1)   # edges to hash
    next_frontier = expand_live(g, fr_src, visited, live, level, seed)

    active_src = bitmask.count_colors(fr_src)               # (E,) per-edge
    per_vertex = bitmask.count_colors(frontier)
    info = dict(
        fused_visits=(active_src > 0).sum(dtype=torch.int32),
        unfused_visits=active_src.sum(dtype=torch.int32),
        frontier_vertices=(per_vertex > 0).sum(dtype=torch.int32),
        frontier_colors=per_vertex.sum(dtype=torch.int32),
    )
    return next_frontier, visited, info


def expand_live(g: Graph, fr_src: torch.Tensor, visited: torch.Tensor,
                live: torch.Tensor, level: int, seed: int) -> torch.Tensor:
    """`fused_step`'s expansion over the ``live`` edges (indices into the
    CSR edge list): draw each one's colours, OR its source's frontier
    words ``fr_src`` (E, W) into its destination, keep what ``visited``
    lacks.  Returns the next frontier."""
    dst = g.dst[live].to(torch.int64)
    contrib = (fr_src[live] & _draw_words(g, live, fr_src.shape[1], level,
                                          seed)
               & ~visited[dst])
    next_frontier = _scatter_or(torch.zeros_like(visited), dst, contrib)
    return next_frontier & ~visited                         # line 11 re-check


def _active_tiles(frontier: torch.Tensor,
                  tile_rows: int = _TILE_ROWS) -> torch.Tensor:
    """Number of ``tile_rows``-row tiles with ≥1 active vertex (Fig. 9
    analogue; the fraction is taken on the host in float32)."""
    pad = (-frontier.shape[0]) % tile_rows
    act = bitmask.count_colors(frontier) > 0
    act = torch.cat([act, act.new_zeros(pad)])
    return act.view(-1, tile_rows).any(1).sum(dtype=torch.int32)


def run_fused(g: Graph, starts, num_colors: int, seed: int,
              max_levels: int = 64) -> TraversalResult:
    """Run the fused BPT to frontier exhaustion (≤ max_levels)."""
    dev = g.device
    frontier = init_frontier(g.num_vertices, num_colors, starts, dev)
    visited = bitmask.make_mask(g.num_vertices, num_colors, dev)
    rows = []
    level = 0
    while level < max_levels and bitmask.any_set(frontier):
        act_tiles = _active_tiles(frontier)
        frontier, visited, info = fused_step(g, frontier, visited, level, seed)
        rows.append(torch.stack([info["fused_visits"],
                                 info["unfused_visits"],
                                 info["frontier_vertices"],
                                 info["frontier_colors"], act_tiles]))
        level += 1
    # Vertices still on the frontier at the level cap count as visited.
    stats = level_stats(rows, level, max_levels, g.num_vertices, num_colors)
    return TraversalResult(visited=visited | frontier, stats=stats)


def level_stats(rows, levels: int, max_levels: int, num_vertices: int,
                num_colors: int, grid_steps=None) -> TraversalStats:
    """`TraversalStats` from the per-level device rows ``(fused, unfused,
    frontier vertices, frontier colours, active 128-row tiles)`` (one host
    copy) and, for gridded paths, the per-level ``grid_steps`` ints."""
    per_level = np.zeros((max_levels, 5), np.int32)
    if rows:
        per_level[:levels] = torch.stack(rows).cpu().numpy()
    fused, unfused, fv, fc, act = per_level.T
    f32 = np.float32
    # XLA compiles the reference's division by the constant num_colors as a
    # product with its float32 reciprocal; doing the same keeps every bit.
    occ = np.where(fv > 0, fc.astype(f32) / np.maximum(fv, 1).astype(f32)
                   * (f32(1) / f32(num_colors)), f32(0)).astype(f32)
    n_tiles = -(-num_vertices // _TILE_ROWS)
    frac = np.zeros(max_levels, f32)     # jnp.mean: sum times 1/count
    frac[:levels] = act[:levels].astype(f32) * (f32(1) / f32(n_tiles))
    steps = np.zeros(max_levels, np.int32)
    if grid_steps is not None:
        steps[:levels] = grid_steps
    return TraversalStats(levels, fused, unfused, fv, fc, occ, frac, steps)


def run_fused_block(g: Graph, starts: np.ndarray, seeds: np.ndarray,
                    num_colors: int, max_levels: int = 64):
    """Traverse a block of batches: starts (B, C) / seeds (B,) →
    (visited (B, V, W), fused (B,), unfused (B,)), the edge-visit totals
    equal to ``run_fused``'s per-level stats summed."""
    results = [run_fused(g, st, num_colors, int(sd), max_levels)
               for st, sd in zip(starts, seeds)]
    return (torch.stack([r.visited for r in results]),
            np.asarray([r.stats.fused_edge_visits.sum() for r in results]),
            np.asarray([r.stats.unfused_edge_visits.sum() for r in results]))


def run_single_color(g: Graph, start: int, color_id: int, seed: int,
                     max_levels: int = 64) -> TraversalResult:
    """Unfused baseline: one BPT on the *global* colour id's RNG stream.

    Each level hashes ``(seed, level, edge id, word*32 + lane)`` for this
    colour only — the fused run's counter — so this run's ``(V, 1)`` mask
    equals bit ``color_id`` of ``run_fused``'s.  Its stats are the
    reference's: ``fused_edge_visits`` = ``unfused_edge_visits`` = edges
    whose source carries the colour (over every padded row: a pad row has
    source 0), ``frontier_vertices``; the other fields stay 0.  Each level
    costs one host sync for the frontier test and one for ``nonzero``.
    """
    dev = g.device
    lane_bit = bitmask.i32(torch.tensor(1 << (color_id % 32), device=dev))
    frontier = torch.zeros((g.num_vertices, 1), dtype=torch.int32,
                           device=dev)
    frontier[int(start), 0] = lane_bit
    visited = torch.zeros_like(frontier)
    src, dst = g.src.to(torch.int64), g.dst.to(torch.int64)
    visits, vertices = [], []
    level = 0
    while level < max_levels and bitmask.any_set(frontier):
        visited = visited | frontier
        live = torch.nonzero(frontier[src, 0]).squeeze(1)   # colour at src
        bits = rng.hash_u32(seed, level, live, color_id)
        drawn = rng.uniform_from_u32(bits) < g.prob[live]
        hit = dst[live][drawn]
        nf = torch.zeros_like(visited)
        nf[hit, 0] = lane_bit                               # scatter-OR
        visits.append(live.numel())
        vertices.append((frontier != 0).sum(dtype=torch.int32))
        frontier = nf & ~visited
        level += 1
    visited = visited | frontier
    per_level = np.zeros((2, max_levels), np.int32)
    per_level[0, :level] = visits
    if vertices:
        per_level[1, :level] = torch.stack(vertices).cpu().numpy()
    zeros_i = np.zeros(max_levels, np.int32)
    zeros_f = np.zeros(max_levels, np.float32)
    stats = TraversalStats(level, per_level[0], per_level[0].copy(),
                           per_level[1], zeros_i, zeros_f, zeros_f.copy(),
                           zeros_i.copy())
    return TraversalResult(visited=visited, stats=stats)


def run_unfused(g: Graph, starts, num_colors: int, seed: int,
                max_levels: int = 64):
    """``num_colors`` separate single-colour BPTs (the unfused baseline of
    the paper's Figs. 7/8).  Returns (the assembled ``(V, W)`` mask, the
    total edge visits as a Python int)."""
    visited = bitmask.make_mask(g.num_vertices, num_colors, g.device)
    total = 0
    for c in range(num_colors):
        res = run_single_color(g, int(starts[c]), c, seed, max_levels)
        visited[:, c // 32] |= res.visited[:, 0]
        total += int(res.stats.fused_edge_visits.astype(np.int64).sum())
    return visited, total
