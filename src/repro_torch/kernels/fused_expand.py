"""CUDA wrapper of ``csrc/fused_expand.cu`` — one fused-BPT IC level over
the dst-sorted adjacency tiles.

Replaces the Pallas kernel ``repro/kernels/fused_expand.py::fused_expand``.
One CTA per destination block walks that block's run of the tile list
(``run_ptr``), so there is no cross-CTA accumulation and no
``first_of_dst``/coverage post-mask; threads hash only live
(row, slot, colour) triples.  The list is every tile (``tile_ids`` None,
``run_ptr`` the layout's ``dst_run_ptr``) or a compacted list of ascending
tile ids read where they lie (the sparse frontier).  Its roofline bound is
set by bytes (see the source's header).  Its plain version is
`kernels.ref.fused_expand_ref`; `kernels.ops.fused_expand` picks between
the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 8
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p])


def check_tile_list(kernel: str, prob, tile_src, run_ptr, frontier, visited,
                    tile_ids, dev, stack_dtype=torch.float32
                    ) -> tuple[int, int, int]:
    """The checks the tile kernels' wrappers share (``prob`` is the stack
    the walk reads, of ``stack_dtype``); returns ``(n_blocks, T, W)``."""
    _build.check_arg(kernel, "tile stack", prob, stack_dtype, 3, dev)
    _build.check_arg(kernel, "tile_src", tile_src, torch.int32, 1, dev)
    _build.check_arg(kernel, "run_ptr", run_ptr, torch.int32, 1, dev)
    _build.check_arg(kernel, "frontier", frontier, torch.int32, 2, dev)
    _build.check_arg(kernel, "visited", visited, torch.int32, 2, dev)
    if tile_ids is not None:
        _build.check_arg(kernel, "tile_ids", tile_ids, torch.int32, 1, dev)
    nt, T, T2 = prob.shape
    w = frontier.shape[1]
    n_blocks = visited.shape[0] // T
    if T != T2 or tile_src.shape[0] != nt:
        raise ValueError(f"{kernel}: tile stacks and tile_src disagree")
    if frontier.shape != visited.shape or visited.shape[0] % T \
            or run_ptr.shape[0] != n_blocks + 1:
        raise ValueError(f"{kernel}: frontier and visited must have one "
                         "shape, rows padded to the tile size, and "
                         "run_ptr n_blocks + 1 entries")
    if T % 32 or not 32 <= T <= 1024 or not 1 <= w <= 8:
        raise ValueError(f"{kernel}: tile size {T} must be a multiple of "
                         f"32 in [32, 1024] and words {w} in [1, 8]")
    return n_blocks, T, w


def fused_expand_cuda(prob: torch.Tensor, edge_id: torch.Tensor,
                      tile_src: torch.Tensor, run_ptr: torch.Tensor,
                      frontier: torch.Tensor, visited: torch.Tensor,
                      seed: int, level: int,
                      tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on ``frontier``'s stream; returns the (Vo, W) int32
    next frontier.  ``visited`` must already include ``frontier`` and have
    its shape; every ``tile_src`` entry must be below ``Vo / T`` (as
    `core.tiles.from_graph` builds them), so the frontier holds every row
    the kernel reads.  ``tile_ids``: ascending int32 ids of the listed
    tiles (None: every tile), with ``run_ptr`` over that list."""
    dev = frontier.device
    n_blocks, T, w = check_tile_list("fused_expand", prob, tile_src, run_ptr,
                                     frontier, visited, tile_ids, dev)
    _build.check_arg("fused_expand", "edge_id", edge_id, torch.int32, 3, dev)
    if edge_id.shape != prob.shape:
        raise ValueError("fused_expand: edge_id and prob stacks disagree")
    fn = _build.load("fused_expand").fused_expand_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(visited)
    err = fn(prob.data_ptr(), edge_id.data_ptr(), _build.data_ptr(tile_ids),
             tile_src.data_ptr(), run_ptr.data_ptr(), frontier.data_ptr(),
             visited.data_ptr(), out.data_ptr(), n_blocks, T, w,
             int(seed) & 0xFFFFFFFF, int(level) & 0xFFFFFFFF,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_expand launch failed: cudaError {err}")
    return out
