"""CUDA wrapper of ``csrc/fused_expand.cu`` — one fused-BPT IC level over
the dst-sorted adjacency tiles.

Replaces the Pallas kernel ``repro/kernels/fused_expand.py::fused_expand``.
One CTA per destination block walks that block's tile run
(``dst_run_ptr``), so there is no cross-CTA accumulation and no
``first_of_dst``/coverage post-mask; threads hash only live
(row, slot, colour) triples.  Its roofline bound is set by bytes (see the
source's header).  Its plain version is
`kernels.ref.fused_expand_ref`; `kernels.ops.fused_expand` picks between
the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 7
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p])


def _check(name: str, t: torch.Tensor, dtype, dim: int, dev) -> None:
    if t.device != dev or t.dtype != dtype or t.dim() != dim \
            or not t.is_contiguous():
        raise ValueError(f"fused_expand: {name} must be a contiguous "
                         f"{dim}-D {dtype} tensor on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def fused_expand_cuda(prob: torch.Tensor, edge_id: torch.Tensor,
                      tile_src: torch.Tensor, dst_run_ptr: torch.Tensor,
                      frontier: torch.Tensor, visited: torch.Tensor,
                      seed: int, level: int) -> torch.Tensor:
    """Launch the kernel on ``frontier``'s stream; returns the (Vo, W) int32
    next frontier.  ``visited`` must already include ``frontier`` and have
    its shape; every ``tile_src`` entry must be below ``Vo / T`` (as
    `core.tiles.from_graph` builds them), so the frontier holds every row
    the kernel reads."""
    dev = frontier.device
    _check("prob", prob, torch.float32, 3, dev)
    _check("edge_id", edge_id, torch.int32, 3, dev)
    _check("tile_src", tile_src, torch.int32, 1, dev)
    _check("dst_run_ptr", dst_run_ptr, torch.int32, 1, dev)
    _check("frontier", frontier, torch.int32, 2, dev)
    _check("visited", visited, torch.int32, 2, dev)
    nt, T, T2 = prob.shape
    w = frontier.shape[1]
    n_blocks = visited.shape[0] // T
    if T != T2 or edge_id.shape != prob.shape or tile_src.shape[0] != nt:
        raise ValueError("fused_expand: tile stacks and tile_src disagree")
    if frontier.shape != visited.shape or visited.shape[0] % T \
            or dst_run_ptr.shape[0] != n_blocks + 1:
        raise ValueError("fused_expand: frontier and visited must have one "
                         "shape, rows padded to the tile size, and "
                         "dst_run_ptr n_blocks + 1 entries")
    if T % 32 or not 32 <= T <= 1024 or not 1 <= w <= 8:
        raise ValueError(f"fused_expand: tile size {T} must be a multiple of "
                         f"32 in [32, 1024] and words {w} in [1, 8]")
    lib = _build.load("fused_expand")
    fn = lib.fused_expand_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(visited)
    err = fn(prob.data_ptr(), edge_id.data_ptr(), tile_src.data_ptr(),
             dst_run_ptr.data_ptr(), frontier.data_ptr(), visited.data_ptr(),
             out.data_ptr(), n_blocks, T, w, int(seed) & 0xFFFFFFFF,
             int(level) & 0xFFFFFFFF, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_expand launch failed: cudaError {err}")
    return out
