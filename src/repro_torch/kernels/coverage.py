"""CUDA wrapper of ``csrc/coverage.cu`` — max-k-cover marginal-gain counts
summed over the pool's batches.

Replaces the Pallas kernel ``repro/kernels/coverage.py::cover_counts``
(vmapped over batches by ``repro/kernels/ops.py::cover_counts_batched``,
then summed by every caller).  A memory-bound ``__popc`` sweep, one thread
per vertex, with the batch sum fused.  Its plain version is
`kernels.ref.cover_counts_ref`; `kernels.ops.cover_counts` picks between
the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]


def cover_counts_cuda(visited: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
    """visited (B, V, W) int32 × active (B, W) int32 → (V,) int32 counts,
    launched on ``visited``'s stream."""
    dev = visited.device
    _build.check_arg("cover_counts", "visited", visited, torch.int32, 3, dev)
    _build.check_arg("cover_counts", "active", active, torch.int32, 2, dev)
    b, v, w = visited.shape
    if active.shape != (b, w):
        raise ValueError(f"cover_counts: active {tuple(active.shape)} != "
                         f"{(b, w)}")
    fn = _build.load("coverage").cover_counts_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    counts = torch.empty(v, dtype=torch.int32, device=dev)
    err = fn(visited.data_ptr(), active.data_ptr(), counts.data_ptr(), b, v,
             w, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cover_counts launch failed: cudaError {err}")
    return counts
