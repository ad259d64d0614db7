"""CUDA wrapper of ``csrc/coverage.cu`` — max-k-cover marginal-gain counts
summed over the pool's batches, for one or several active masks per batch.

Replaces the Pallas kernel ``repro/kernels/coverage.py::cover_counts``
(vmapped over batches by ``repro/kernels/ops.py::cover_counts_batched``,
then summed by every caller, and mapped over query slots by the serving
engine).  A memory-bound ``__popc`` sweep shaped for the card's bandwidth:
16-byte loads over each batch's flat slab, several batches' loads in
flight per thread, the batch range split over the grid with partial sums
met by ``atomicAdd``, and the Q masks of one launch counted from one read
of the stack.  Its plain versions are `kernels.ref.cover_counts_ref` and
`kernels.ref.cover_counts_multi_ref`; `kernels.ops.cover_counts` and
`kernels.ops.cover_counts_multi` pick between the kernel and them by
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def cover_counts_cuda(visited: torch.Tensor,
                      active_q: torch.Tensor) -> torch.Tensor:
    """visited (B, V, W) int32 × active_q (B, Q, W) int32 → (Q, V) int32
    counts, launched on ``visited``'s stream."""
    dev = visited.device
    _build.check_arg("cover_counts", "visited", visited, torch.int32, 3, dev)
    _build.check_arg("cover_counts", "active", active_q, torch.int32, 3, dev)
    b, v, w = visited.shape
    q = active_q.shape[1]
    if active_q.shape != (b, q, w) or w < 1:
        raise ValueError(f"cover_counts: active {tuple(active_q.shape)} must "
                         f"be (B, Q, W) = ({b}, Q, {w}), W >= 1")
    fn = _build.launcher("coverage", "cover_counts_launch", _ARGTYPES)
    counts = torch.empty((q, v), dtype=torch.int32, device=dev)
    err = fn(visited.data_ptr(), active_q.data_ptr(), counts.data_ptr(), b, v,
             w, q, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cover_counts launch failed: cudaError {err}")
    return counts

