"""Fused BPT on the block-sparse tile layout (PyTorch port of
``repro.core.tiled_traversal``).

Same level-synchronous semantics as `core.traversal.run_fused` (IC) and
`core.lt.run_fused_lt` (LT), with each level's expansion going through the
tile kernels — `kernels.ops.fused_expand` and `kernels.ops.lt_select_expand`:
the CUDA kernels on a GPU, their plain versions on CPU tensors.  IC draws
by CSR edge id and LT by destination vertex, so the visited masks equal the
CSR sweeps' bit for bit.  `run_fused_q_tiled` runs IC on the quantised
layout (`kernels.ops.fused_expand_q`), whose draws are its own.

``frontier="sparse"`` compacts each level to the tiles whose source block
holds an active vertex: their ascending ids form the level's tile list
(`tiles.active_tile_ids`), which the kernels walk in place.  The reference
gathers those tiles into a capacity-rung buffer padded with a null tile;
the port's list has the exact length and copies no stack.  Skipped tiles
have no active source row, so sparse equals dense by construction.

Both runners return ``(visited, levels_run, grid_steps)`` as the reference
does: ``grid_steps`` is ``levels · num_tiles`` on the dense grid and the
sum of the per-level ladder rungs (`sparse.ladder_rung`) on the compacted
one, so `scripts/check_work_counters.py`'s comparison reads the same
quantity.  A ``work`` dict, when given, receives the per-level
``grid_steps``, the exact ``active_tiles`` the kernels walked and the
traversal's blocking device reads (``syncs``).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.core import bitmask, sparse, tiles
from repro_torch.core.traversal import init_frontier
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


def _run_levels(tg: tiles.TiledGraph, starts, num_colors: int,
                max_levels: int, frontier: str, ladder, expand, work):
    """The level loop both runners share; ``expand(fr, vis, level,
    tile_ids)`` is one kernel level over every tile (``tile_ids`` None) or
    the listed ones.  Each level is a `tracing` span ``level``; the test
    of a frontier is launched with the level's kernel and read apart
    (``level.sync``), so the blocking read stands alone."""
    if frontier not in ("dense", "sparse"):
        raise ValueError(f"frontier {frontier!r} not in ('dense', 'sparse')")
    if frontier == "sparse" and ladder is None:
        ladder = sparse.bucket_ladder(tg.num_tiles)
    with tracing.span("frontier.init"):
        fr = tiles.pad_mask_rows(
            init_frontier(tg.num_vertices, num_colors, starts, tg.device),
            tg.padded_vertices)
        visited = torch.zeros_like(fr)
    steps, active = [], []
    level = syncs = 0                # syncs: blocking device reads
    live = max_levels > 0
    if live:
        with tracing.span("level.sync"):
            live = bitmask.any_set(fr)
        syncs += 1
    while live and level < max_levels:
        with tracing.span("level"):
            ids = None
            if frontier == "sparse":
                with tracing.span("level.compact"):
                    ids = tiles.active_tile_ids(
                        tg.tile_src,
                        sparse.row_block_activity(fr, tg.tile_size))
                    active.append(int(ids.numel()))      # nonzero's read
                syncs += 1
                steps.append(sparse.ladder_rung(active[-1], ladder))
            else:
                active.append(tg.num_tiles)
                steps.append(tg.num_tiles)
            with tracing.span("level.expand"):
                visited |= fr                            # Listing 1 line 8
                fr = expand(fr, visited, level, ids)
                level += 1
                if level < max_levels:
                    test = bitmask.any_set_flag(fr)
            if level < max_levels:
                with tracing.span("level.sync"):
                    live = bool(test)
                syncs += 1
    visited |= fr                                        # cap-level colours
    if work is not None:
        work.update(grid_steps=steps, active_tiles=active, syncs=syncs)
    return visited[: tg.num_vertices], level, sum(steps)


def run_fused_tiled(tg: tiles.TiledGraph, starts, num_colors: int, seed: int,
                    max_levels: int = 64, frontier: str = "dense",
                    ladder: tuple[int, ...] | None = None,
                    work: dict | None = None):
    """IC on the tile layout: ``(visited (V, W) int32, levels_run,
    grid_steps)``.  ``ladder`` overrides the sparse grid's capacity rungs
    (default `sparse.bucket_ladder` of the tile count)."""
    def expand(fr, vis, level, tile_ids):
        return ops.fused_expand(tg, fr, vis, seed, level, tile_ids=tile_ids)

    return _run_levels(tg, starts, num_colors, max_levels, frontier, ladder,
                       expand, work)


def run_fused_lt_tiled(tg: tiles.TiledGraph, cb_tiles: torch.Tensor, starts,
                       num_colors: int, seed: int, max_levels: int = 64,
                       frontier: str = "dense",
                       ladder: tuple[int, ...] | None = None,
                       work: dict | None = None):
    """LT on the tile layout of the LT-normalised graph: ``cb_tiles`` is
    ``tiles.lt_cb_tiles(tg, g, lt.selection_cum_before(g))``; a cb stack
    built another way has its slot list read from the stacks.
    The uniform table is computed once per traversal.  Returns as
    `run_fused_tiled`."""
    u = kref.lt_selection_uniforms(seed, tg.padded_vertices, num_colors,
                                   device=tg.device)

    def expand(fr, vis, level, tile_ids):
        return ops.lt_select_expand(tg, cb_tiles, fr, vis, u,
                                    tile_ids=tile_ids)

    return _run_levels(tg, starts, num_colors, max_levels, frontier, ladder,
                       expand, work)


def run_fused_q_tiled(tg: tiles.TiledGraph, q8: torch.Tensor, starts,
                      num_colors: int, seed: int, max_levels: int = 64,
                      frontier: str = "dense",
                      ladder: tuple[int, ...] | None = None,
                      work: dict | None = None):
    """IC on the quantised tile layout (``tg, q8 = tiles.quantized(g)``),
    each level through `kernels.ops.fused_expand_q`.  Returns as
    `run_fused_tiled`.

    This is the level loop of the reference's ``graph_q`` dryrun cell
    (``repro/launch/dryrun.py:260-281``, ``body``) at one shard, where its
    ``all_gather`` over the ``"model"`` axis is the identity: levels run
    until the frontier empties or ``max_levels`` have run, each one
    ``fused_expand_q_ref`` of the frontier against ``visited | frontier``
    at the level's index.  The JAX package has this loop only inside that
    cell; no sampler or launcher option selects it in either package.
    The quantised draws are not the CSR path's: they agree with it exactly
    at p = 0 and p = 1, and in distribution otherwise (p̂ = (q + 1)/256)."""
    def expand(fr, vis, level, tile_ids):
        return ops.fused_expand_q(tg, q8, fr, vis, seed, level,
                                  tile_ids=tile_ids)

    return _run_levels(tg, starts, num_colors, max_levels, frontier, ladder,
                       expand, work)
