"""CUDA wrapper of ``csrc/lt_select_expand.cu`` — one fused-BPT LT level
over the dst-sorted adjacency tiles.

Replaces the Pallas kernel
``repro/kernels/lt_select_expand.py::lt_select_expand``.  The design is
``fused_expand``'s (one CTA per destination block over the tile list's run
pointers, live source rows only), with the IC Bernoulli draw replaced by
the fixed live-edge test ``cb ≤ u[dst, c] < cb + prob`` on the
per-traversal uniform table; bytes bound it (see the source's header).
Its plain version is `kernels.ref.lt_select_expand_ref`;
`kernels.ops.lt_select_expand` picks between the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def check_tile_list(kernel: str, prob, tile_src, run_ptr, frontier, visited,
                    tile_ids, dev) -> tuple[int, int, int]:
    """The checks of a tile-walk wrapper (``prob`` the float32 stack the
    walk reads); returns ``(n_blocks, T, W)``."""
    _build.check_arg(kernel, "tile stack", prob, torch.float32, 3, dev)
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


def lt_select_expand_cuda(prob: torch.Tensor, cb: torch.Tensor,
                          tile_src: torch.Tensor, run_ptr: torch.Tensor,
                          frontier: torch.Tensor, visited: torch.Tensor,
                          u: torch.Tensor,
                          tile_ids: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Launch the kernel on ``frontier``'s stream; returns the (Vo, W) int32
    next frontier.  Arguments as `fused_expand_cuda`, with ``cb`` the
    selection-CDF prefixes in ``prob``'s layout and ``u`` the (Vo, W·32)
    float32 uniform table of `kernels.ref.lt_selection_uniforms`."""
    dev = frontier.device
    n_blocks, T, w = check_tile_list("lt_select_expand", prob, tile_src,
                                     run_ptr, frontier, visited, tile_ids,
                                     dev)
    _build.check_arg("lt_select_expand", "cb", cb, torch.float32, 3, dev)
    _build.check_arg("lt_select_expand", "u", u, torch.float32, 2, dev)
    if cb.shape != prob.shape or u.shape != (visited.shape[0], w * 32):
        raise ValueError(f"lt_select_expand: cb {tuple(cb.shape)} must have "
                         f"prob's shape and u {tuple(u.shape)} "
                         f"{(visited.shape[0], w * 32)}")
    fn = _build.load("lt_select_expand").lt_select_expand_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(visited)
    err = fn(prob.data_ptr(), cb.data_ptr(), _build.data_ptr(tile_ids),
             tile_src.data_ptr(), run_ptr.data_ptr(), frontier.data_ptr(),
             visited.data_ptr(), u.data_ptr(), out.data_ptr(), n_blocks, T,
             w, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lt_select_expand launch failed: cudaError "
                           f"{err}")
    return out
