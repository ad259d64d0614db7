"""Fused BPT on the block-sparse tile layout (PyTorch port of
``repro.core.tiled_traversal``, dense frontier, IC).

Same level-synchronous semantics as `core.traversal.run_fused`, with each
level's expansion going through the tile formulation,
`kernels.ops.fused_expand`: the CUDA kernel on a GPU, its plain version on
CPU tensors.  Both share the counter RNG keyed by CSR edge id, so the
visited masks equal the CSR sweep's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmask, tiles
from repro_torch.core.traversal import init_frontier
from repro_torch.kernels import ops


def run_fused_tiled(tg: tiles.TiledGraph, starts, num_colors: int, seed: int,
                    max_levels: int = 64):
    """Returns ``(visited (V, W) int32, levels_run, grid_steps)`` with
    ``grid_steps == levels_run * num_tiles`` (every level sweeps every
    tile)."""
    dev = tg.prob.device
    fr = tiles.pad_mask_rows(
        init_frontier(tg.num_vertices, num_colors, starts, dev),
        tg.padded_vertices)
    visited = torch.zeros_like(fr)
    level = 0
    while level < max_levels and bitmask.any_set(fr):
        visited |= fr                                    # Listing 1 line 8
        fr = ops.fused_expand(tg, fr, visited, seed, level)
        level += 1
    visited |= fr                                        # cap-level colours
    return visited[: tg.num_vertices], level, level * tg.num_tiles
