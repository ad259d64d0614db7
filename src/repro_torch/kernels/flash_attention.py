"""CUDA wrapper of ``csrc/flash_attention.cu`` — blocked online-softmax
attention for the LM substrate's prefill and decode.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``.  One CTA per (64-row query block, head, batch) loops
over 64-key blocks of K and V in shared memory with the online-softmax
recurrence in float32; grouped-query heads are read in place (query head
``h`` reads KV head ``h // (H // KVH)``), and under ``causal`` the loop
stops at the last block a row of the CTA can see.  Tile sizes belong to
the kernel: the reference's ``block_q``/``block_k`` tiling knobs have no
counterpart.  Operations bound it at the prefill shape and bytes at the
decode shape (see the source's header).  Its plain version is
`kernels.ref.flash_attention_ref`; `kernels.ops.flash_attention` picks
between the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, scale: float,
                         kv_offset: int) -> torch.Tensor:
    """Launch the kernel on ``q``'s stream: q (B, Lq, H, D), k and v
    (B, Lk, KVH, D), one dtype (float32 or bfloat16), contiguous; returns
    the (B, Lq, H, D) output in q's dtype."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is neither "
                         "float32 nor bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_arg("flash_attention", name, t, q.dtype, 4, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned")
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, lk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Lk, KVH, D) with q's "
                         f"B and D, q {tuple(q.shape)}")
    if d % 16 or not 16 <= d <= 256 or h % kvh or min(b, lq, lk) < 1 \
            or kv_offset < 0 or b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: needs D a multiple of 16 in "
                         f"[16, 256] (got {d}), H a multiple of KVH (got "
                         f"{h}, {kvh}), B, Lq, Lk >= 1 (got {b}, {lq}, "
                         f"{lk}) and kv_offset >= 0 (got {kv_offset})")
    out = torch.empty_like(q)
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], b, lq, lk, h, kvh, d, scale, int(causal),
             kv_offset, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    return out
