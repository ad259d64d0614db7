"""The quantised IC expansion: ``quantize_probs`` and the CUDA wrapper of
``csrc/fused_expand_q.cu``.

Replaces both Pallas kernels of ``repro/kernels/fused_expand_q.py``:
``fused_expand_q`` (the dense grid) and ``fused_expand_q_gathered`` (a
compacted, null-padded tile list).  The tile stack is one uint8 threshold
``q`` per slot (1 B where the float32 layout needs 8 B of probability and
edge id), the RNG counter is the slot's position ``tile·T² + row·T + col``
(mod 2³²), and one hash feeds four colour lanes:

    colour c crosses the edge in slot s  ⇔  byte (c % 4) of
        hash_u32(seed, level, cell(s), c // 4)  ≤  q[s]  ∧  q[s] > 0,

so p̂ = (q + 1)/256, exact at p = 0 and p = 1.  The kernel keeps
``fused_expand``'s walk (one CTA per destination block over run pointers,
live source rows only, the tile list every tile or a list of original ids
read in place), so the list mode needs no null tile and no gathered copy.
Its plain version is `kernels.ref.fused_expand_q_ref`;
`kernels.ops.fused_expand_q` picks between the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_expand import check_tile_list

_ARGTYPES = ([ctypes.c_void_p] * 7
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p])


def quantize_probs(prob: torch.Tensor) -> torch.Tensor:
    """float32 probabilities in [0, 1] → uint8 thresholds
    ``clip(round(p·256) − 1, 0, 255)``, 0 where ``p ≤ 0`` (the reference's
    ``fused_expand_q.py::quantize_probs``).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the k/256 boundaries agree."""
    prob = prob.to(torch.float32)
    q = torch.clamp(torch.round(prob * 256.0) - 1.0, 0, 255)
    return torch.where(prob > 0, q, 0).to(torch.uint8)


def fused_expand_q_cuda(q8: torch.Tensor, tile_src: torch.Tensor,
                        run_ptr: torch.Tensor, frontier: torch.Tensor,
                        visited: torch.Tensor, seed: int, level: int,
                        tile_ids: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Launch the kernel on ``frontier``'s stream; returns the (Vo, W) int32
    next frontier.  Arguments as `fused_expand_cuda`, with ``q8`` the
    (nt, T, T) uint8 threshold stack in place of ``prob`` and ``edge_id``;
    a listed tile draws with its own id."""
    dev = frontier.device
    n_blocks, T, w = check_tile_list("fused_expand_q", q8, tile_src, run_ptr,
                                     frontier, visited, tile_ids, dev,
                                     stack_dtype=torch.uint8)
    fn = _build.load("fused_expand_q").fused_expand_q_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(visited)
    err = fn(q8.data_ptr(), _build.data_ptr(tile_ids), tile_src.data_ptr(),
             run_ptr.data_ptr(), frontier.data_ptr(), visited.data_ptr(),
             out.data_ptr(), n_blocks, T, w, int(seed) & 0xFFFFFFFF,
             int(level) & 0xFFFFFFFF,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_expand_q launch failed: cudaError {err}")
    return out
