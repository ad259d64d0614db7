"""CUDA wrapper of ``csrc/lt_select_expand.cu`` — one fused-BPT LT level
over the slot list of the dst-sorted adjacency tiles.

Replaces the Pallas kernel
``repro/kernels/lt_select_expand.py::lt_select_expand``.  The kernel walks
the layout's LT slot list (`core.tiles.lt_slot_list`: per tile, the slots
with ``prob > 0``, each with its source and destination rows, its
probability and its selection-CDF prefix ``cb`` as float32 bits) through
``fused_expand``'s walk (``csrc/slot_expand.cuh``): one thread per entry,
a warp merge by destination row and ``atomicOr``, every entry or those of
a compacted list of ascending tile ids read in place.  Its gate is the
fixed live-edge test ``cb ≤ u[dst, c] < cb + prob`` on the per-traversal
uniform table; bytes bound it (see the source's header).  Its plain
version is `kernels.ref.lt_select_expand_slots_ref`, which the tile-form
`kernels.ref.lt_select_expand_ref` defines; `kernels.ops.lt_select_expand`
picks between the kernel and the plain version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_expand import launch_slot_kernel


def lt_select_expand_cuda(slots, frontier: torch.Tensor,
                          visited: torch.Tensor, u: torch.Tensor,
                          tile_ids: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Launch the kernel on ``frontier``'s stream; returns the (Vo, W) int32
    next frontier.  ``slots`` is the layout's `core.tiles.lt_slot_list`;
    ``u`` the (Vo, W·32) float32 uniform table of
    `kernels.ref.lt_selection_uniforms`; the rest as
    `kernels.fused_expand.fused_expand_cuda`."""
    _build.check_arg("lt_select_expand", "u", u, torch.float32, 2,
                     frontier.device)
    want = (visited.shape[0], frontier.shape[1] * 32)
    if tuple(u.shape) != want:
        raise ValueError(f"lt_select_expand: u {tuple(u.shape)} must be "
                         f"{want}, a row of W·32 uniforms per mask row")
    return launch_slot_kernel("lt_select_expand", torch.float32, slots,
                              frontier, visited, tile_ids,
                              (ctypes.c_void_p(u.data_ptr()),))
