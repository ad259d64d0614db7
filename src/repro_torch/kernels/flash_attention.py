"""CUDA wrappers of the flash-attention kernels — blocked online-softmax
attention for the LM substrate's prefill and decode.

Replace the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``.  Four routes compute the reference's function, and
`route` picks one from the call's shapes alone (no flag or environment
variable):

- ``wgmma`` (``csrc/flash_prefill_wgmma.cu``): bf16, ``Lq > 1``, head dim
  64, 80, 96, 128 or 192 — the prefill of the dense family, zamba2's
  shared block (80), phi-3-vision (96) and nemotron (192).  A CTA of two
  consumer warpgroups and a producer warp; TMA copies K/V blocks (of 64
  keys at D 192, else 128) into a two-stage ring, ``wgmma`` computes both
  products on the tensor cores.
- ``decode`` (``csrc/flash_decode.cu``): ``Lq == 1``, float32 or bf16 —
  every decode step.  A split-K grid over (key split, KV head, batch),
  one CTA per split for all query heads of a KV group, streaming its keys
  through a ``cp.async`` ring in shared memory; the partials are merged
  in the same launch by the last CTA of each group, which can also write
  each head's log-sum-exp (the sequence-parallel decode's merge input).
- ``tf32x3`` (``csrc/flash_prefill_tf32x3.cu``): float32, ``Lq > 1``, a
  head dim of `WGMMA_HEAD_DIMS` — every float32 prefill and training
  forward of the registry's archs.  A CTA of 8 warps per 128 query rows,
  K/V blocks of 64 keys by ``cp.async``, every product on the tensor cores
  as three TF32 passes (``mma.sync``; hi and lo of each operand split in
  registers), which keeps float32's accuracy (`ref.tf32x3_matmul`
  emulates it).
- ``simt`` (``csrc/flash_attention.cu``): everything else (float32 or
  bf16 with ``Lq > 1`` at another head dim, such as 16 or 32).  One CTA
  per (64-row query block, head, batch), float32 FMA on the CUDA cores.

Tile sizes belong to the kernels: the reference's ``block_q``/``block_k``
tiling knobs have no counterpart.  The plain version is
`kernels.ref.flash_attention_ref` (and `ref.flash_decode_splitk_ref`,
the decode route's split and merge); `kernels.ops.flash_attention` picks
between plain and kernel by device and counts each route's launches.

The gradient (which the reference does not have: it differentiates its
jnp scan) takes Lq == Lk and ``kv_offset`` 0, and has three routes, which
`route_bwd` picks from the shapes alone:

- ``wgmma`` (``csrc/flash_bwd_wgmma.cu``): bf16 at a head dim of
  `WGMMA_HEAD_DIMS` with L > 1, the calls whose forward took the
  ``wgmma`` route, which writes each row's log-sum-exp (``lse``) for it.
  `flash_bwd_wgmma_dq_cuda` then `flash_bwd_wgmma_dkdv_cuda`, tensor-core
  tiles fed by TMA.
- ``tf32x3`` (``csrc/flash_bwd_tf32x3.cu``): float32 where the forward
  took its ``tf32x3`` route, reading the log-sum-exp it wrote.
  `flash_bwd_tf32x3_dq_cuda` then `flash_bwd_tf32x3_dkdv_cuda`, 3xTF32
  ``mma.sync`` tiles fed by ``cp.async``.
- ``simt`` (``csrc/flash_attention_bwd.cu``): float32 and bf16 at D 16
  and 32 (the kernel takes every head dim of `SIMT_BWD_HEAD_DIMS`, 16 to
  192).  `flash_bwd_dq_cuda` then `flash_bwd_dkdv_cuda`, float32 FMA on
  the CUDA cores, the log-sum-exp recomputed.

On every route, at a head dim of `SPLIT_DKDV_HEAD_DIMS` (192) the second
launch is two, dv then dk (``flash_bwd_<route>_dv_cuda`` and
``flash_bwd_<route>_dk_cuda``; ``flash_bwd_dv_cuda`` and
``flash_bwd_dk_cuda`` on ``simt``), each holding one gradient in
registers.

Their plain version is `ref.flash_attention_bwd_ref` (with ``lse`` for
the routes of `LSE_BWD_ROUTES`), and `ops.flash_attention`'s autograd
rule calls them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

ROUTES = ("wgmma", "decode", "tf32x3", "simt")
BWD_ROUTES = ("wgmma", "tf32x3", "simt")
# The backward routes that read the forward's log-sum-exp.
LSE_BWD_ROUTES = ("wgmma", "tf32x3")
# Head dims of the tensor-core routes: ``wgmma`` (bf16), ``tf32x3``
# (float32), forward and backward.
WGMMA_HEAD_DIMS = (64, 80, 96, 128, 192)
SIMT_BWD_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192)
# Every head dim some backward route takes.
BWD_HEAD_DIMS = tuple(sorted(set(WGMMA_HEAD_DIMS + SIMT_BWD_HEAD_DIMS)))
# Head dims whose backward (either route) takes dk and dv in two launches.
SPLIT_DKDV_HEAD_DIMS = (192,)
# The decode route's split: rows per sub-block (a split's length is a
# multiple), query heads per CTA, the most splits one group merges
# (csrc/flash_decode.cu's MAX_CHUNKS), and CTAs per SM the grid aims at.
SUB_BLOCK, HEADS_PER_CTA, MAX_CHUNKS, CTAS_PER_SM = 32, 4, 2048, 4

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_DKDV_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
_BWD_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_WGMMA_DKDV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                            + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p])
# The dk/dv launch's ``part``: both gradients, or dv or dk alone.
_DKDV, _DV, _DK = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, b: int, lq: int, lk: int, h: int, kvh: int,
          d: int, causal: bool) -> str:
    """The kernel that serves a call of these shapes: ``"decode"`` for one
    query row; at a head dim of `WGMMA_HEAD_DIMS` ``"wgmma"`` for a bf16
    prefill and ``"tf32x3"`` for a float32 one; ``"simt"`` otherwise."""
    if lq == 1:
        return "decode"
    return _tensor_core_route(dtype, d) or "simt"


def _tensor_core_route(dtype: torch.dtype, d: int) -> str | None:
    if d not in WGMMA_HEAD_DIMS:
        return None
    return {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}.get(dtype)


def route_bwd(dtype: torch.dtype, L: int, d: int) -> str:
    """The gradient's kernel for a call of these shapes: the forward's
    route where that was ``"wgmma"`` or ``"tf32x3"`` (L > 1, a head dim of
    `WGMMA_HEAD_DIMS`, bf16 or float32), ``"simt"`` otherwise."""
    return (_tensor_core_route(dtype, d) if L > 1 else None) or "simt"


def bwd_head_dims(route_name: str) -> tuple:
    """The head dims the backward of ``route_name`` (of `BWD_ROUTES`)
    takes."""
    return (WGMMA_HEAD_DIMS if route_name in LSE_BWD_ROUTES
            else SIMT_BWD_HEAD_DIMS)


def bwd_launches(dtype: torch.dtype, L: int, d: int) -> int:
    """Kernel launches of one backward call of these shapes on the card:
    two, or three at `SPLIT_DKDV_HEAD_DIMS` (every route)."""
    return 3 if d in SPLIT_DKDV_HEAD_DIMS else 2


def visible_keys(lk: int, causal: bool, kv_offset: int) -> int:
    """Keys the single query row of a decode step attends: ``0 ..
    kv_offset`` under ``causal``, all ``lk`` otherwise."""
    return min(lk, kv_offset + 1) if causal else lk


def decode_split(b: int, kvh: int, h: int, n_vis: int,
                 sms: int) -> tuple[int, int]:
    """(split length, split count) of the decode route's grid over the
    ``n_vis`` visible keys: as many splits per (batch, KV head, head
    group) as make the grid about CTAS_PER_SM CTAs per SM, each a
    multiple of SUB_BLOCK keys; keys past the visible ones are not
    launched."""
    groups = b * kvh * -(-(h // kvh) // HEADS_PER_CTA)
    splits = min(MAX_CHUNKS, -(-CTAS_PER_SM * sms // groups))
    chunk = SUB_BLOCK * -(-(-(-n_vis // SUB_BLOCK)) // splits)
    return chunk, -(-n_vis // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, kernel: str, dtypes) -> tuple[int, int, int, int, int,
                                                   int]:
    """Raise unless q (B, Lq, H, D), k and v (B, Lk, KVH, D) are what the
    kernels take; returns (B, Lq, Lk, H, KVH, D)."""
    dev = q.device
    if q.dtype not in dtypes:
        raise ValueError(f"{kernel}: dtype {q.dtype} is not one of "
                         f"{', '.join(map(str, dtypes))}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_arg(kernel, name, t, q.dtype, 4, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} is not 16-byte aligned")
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, lk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"{kernel}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Lk, KVH, D) with q's "
                         f"B and D, q {tuple(q.shape)}")
    if d % 16 or not 16 <= d <= 256 or kvh < 1 or h % kvh \
            or min(b, lq, lk) < 1 or b > 65535 or h > 65535:
        raise ValueError(f"{kernel}: needs D a multiple of 16 in [16, 256] "
                         f"(got {d}), H a multiple of KVH (got {h}, {kvh}) "
                         f"and B, Lq, Lk >= 1 (got {b}, {lq}, {lk})")
    return b, lq, lk, h, kvh, d


def _raise_on(err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed: "
                           + (f"CUresult {err - 10000} (tensor map)"
                              if err >= 10000 else f"cudaError {err}"))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, scale: float,
                         kv_offset: int) -> torch.Tensor:
    """The ``simt`` route on ``q``'s stream: q (B, Lq, H, D), k and v
    (B, Lk, KVH, D), one dtype (float32 or bfloat16), contiguous; returns
    the (B, Lq, H, D) output in q's dtype."""
    b, lq, lk, h, kvh, d = _check(q, k, v, "flash_attention", _DTYPES)
    if kv_offset < 0:
        raise ValueError(f"flash_attention: kv_offset {kv_offset} < 0")
    out = torch.empty_like(q)
    fn = _build.launcher("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, lq, lk, h, kvh, d, scale, int(causal),
                 kv_offset, torch.cuda.current_stream(q.device).cuda_stream),
              "flash_attention")
    return out


def _check_lse(t, kernel: str, b: int, h: int, lq: int, dev,
               name: str = "lse") -> None:
    """Raise unless ``t`` is a contiguous float32 (B, H, Lq) tensor, one
    value a query row (the log-sum-exp, or the backward's Δ)."""
    _build.check_arg(kernel, name, t, torch.float32, 3, dev)
    if t.shape != (b, h, lq):
        raise ValueError(f"{kernel}: {name} must be ({b}, {h}, {lq}), got "
                         f"{tuple(t.shape)}")


def _prefill_tc(src: str, dtype: torch.dtype, q, k, v, causal: bool,
                scale: float, kv_offset: int, lse) -> torch.Tensor:
    """One launch of the tensor-core prefill ``csrc/<src>.cu`` (``wgmma``
    in bf16, ``tf32x3`` in float32), after the checks both take."""
    b, lq, lk, h, kvh, d = _check(q, k, v, src, (dtype,))
    if d not in WGMMA_HEAD_DIMS or kv_offset < 0:
        raise ValueError(f"{src}: needs D in {WGMMA_HEAD_DIMS} (got {d}) "
                         f"and kv_offset >= 0 (got {kv_offset})")
    if lse is not None:
        _check_lse(lse, src, b, h, lq, q.device)
    out = torch.empty_like(q)
    fn = _build.launcher(src, f"{src}_launch", _WGMMA_ARGTYPES)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _build.data_ptr(lse), b, lq, lk, h, kvh, d, scale,
                 int(causal), kv_offset,
                 torch.cuda.current_stream(q.device).cuda_stream), src)
    return out


def flash_prefill_wgmma_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool, scale: float,
                             kv_offset: int,
                             lse: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The ``wgmma`` route on ``q``'s stream: bf16 q (B, Lq, H, D), k and v
    (B, Lk, KVH, D), D one of `WGMMA_HEAD_DIMS`, contiguous; returns the
    output in bf16.  Given a float32 (B, H, Lq) ``lse``, the kernel also
    writes each row's natural log-sum-exp there (the backward's input);
    without one it writes nothing more."""
    return _prefill_tc("flash_prefill_wgmma", torch.bfloat16, q, k, v,
                       causal, scale, kv_offset, lse)


def flash_prefill_tf32x3_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool, scale: float,
                              kv_offset: int,
                              lse: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """The ``tf32x3`` route on ``q``'s stream: float32 q (B, Lq, H, D), k
    and v (B, Lk, KVH, D), D one of `WGMMA_HEAD_DIMS`, contiguous, 16-byte
    aligned; returns the float32 output.  Given a float32 (B, H, Lq)
    ``lse``, the kernel also writes each row's natural log-sum-exp there
    (the ``tf32x3`` backward's input); without one it writes nothing
    more."""
    return _prefill_tc("flash_prefill_tf32x3", torch.float32, q, k, v,
                       causal, scale, kv_offset, lse)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, scale: float, kv_offset: int,
                      lse: torch.Tensor | None = None) -> torch.Tensor:
    """The ``decode`` route on ``q``'s stream: q (B, 1, H, D), k and v
    (B, Lk, KVH, D), float32 or bfloat16, contiguous.  The visible keys
    are split as `decode_split` picks; the partials and the arrival
    counters live in scratch of this call's own.  Given a float32 (B, H,
    1) ``lse``, the CTA that merges a head group's splits also writes each
    head's natural log-sum-exp there (``m + log l`` of the merged
    partials); without one it writes nothing more.  A call that sees no
    key is refused (`ops.flash_attention` answers it without a launch)."""
    b, lq, lk, h, kvh, d = _check(q, k, v, "flash_decode", _DTYPES)
    if lq != 1 or kv_offset < 0:
        raise ValueError(f"flash_decode: needs Lq 1 (got {lq}) and "
                         f"kv_offset >= 0 (got {kv_offset})")
    if lse is not None:
        _check_lse(lse, "flash_decode", b, h, 1, q.device)
    n_vis = visible_keys(lk, causal, kv_offset)
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    chunk, n_chunks = decode_split(b, kvh, h, n_vis, _sm_count(index))
    heads = -(-(h // kvh) // HEADS_PER_CTA)
    groups = b * kvh * heads
    if kvh * heads > 65535:
        raise ValueError(f"flash_decode: {kvh * heads} KV head groups (at "
                         f"most 65535)")
    out = torch.empty_like(q)
    # The partials (m, l, acc) of every split, then one counter per group.
    part = torch.empty(groups * (n_chunks * HEADS_PER_CTA * (d + 2) + 1),
                       dtype=torch.float32, device=q.device)
    fn = _build.launcher("flash_decode", "flash_decode_launch",
                         _DECODE_ARGTYPES)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _build.data_ptr(lse), part.data_ptr(), _DTYPES[q.dtype], b,
                 lk, h, kvh, d, scale,
                 n_vis, chunk, n_chunks,
                 torch.cuda.current_stream(q.device).cuda_stream),
              "flash_decode")
    return out


CUDA_ROUTES = {"wgmma": flash_prefill_wgmma_cuda,
               "decode": flash_decode_cuda,
               "tf32x3": flash_prefill_tf32x3_cuda,
               "simt": flash_attention_cuda}


def _check_bwd(q, k, v, o, do, kernel: str,
               dims: tuple = SIMT_BWD_HEAD_DIMS) -> tuple[int, int, int,
                                                          int, int]:
    """Raise unless the backward takes these tensors: `_check`'s layouts
    with Lq == Lk, D one of ``dims`` (the route's), and o and do like q;
    returns (B, L, H, KVH, D)."""
    b, lq, lk, h, kvh, d = _check(q, k, v, kernel, _DTYPES)
    if lq != lk or d not in dims:
        raise ValueError(f"{kernel}: needs Lq == Lk (got {lq}, {lk}) and D "
                         f"in {dims} (got {d})")
    for name, t in (("o", o), ("do", do)):
        _build.check_arg(kernel, name, t, q.dtype, 4, q.device)
        if t.shape != q.shape or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be q's shape "
                             f"{tuple(q.shape)} and 16-byte aligned, got "
                             f"{tuple(t.shape)}")
    return b, lq, h, kvh, d


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                      scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``simt`` backward's first launch on ``q``'s stream: q, o and
    do (B, L, H, D), k and v (B, L, KVH, D), one dtype, contiguous.
    Returns dq in q's dtype and the float32 (2, B, H, L) scratch of each
    row's log-sum-exp and Δ that `flash_bwd_dkdv_cuda` reads."""
    b, L, h, kvh, d = _check_bwd(q, k, v, o, do, "flash_bwd_dq")
    dq = torch.empty_like(q)
    stats = torch.empty((2, b, h, L), dtype=torch.float32, device=q.device)
    fn = _build.launcher("flash_attention_bwd", "flash_bwd_dq_launch",
                         _BWD_ARGTYPES)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), stats.data_ptr(),
                 _DTYPES[q.dtype], b, L, h, kvh, d, scale, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream),
              "flash_bwd_dq")
    return dq, stats


def _check_part(part: int, d: int, kernel: str) -> None:
    """Raise unless a dk/dv launch of ``part`` suits head dim ``d``: both
    gradients in one launch, or (at `SPLIT_DKDV_HEAD_DIMS`) one of them."""
    split = d in SPLIT_DKDV_HEAD_DIMS
    if split != (part != _DKDV):
        raise ValueError(f"{kernel}: D {d} takes "
                         + ("dv and dk in two launches" if split
                            else "dk and dv in one launch"))


def _bwd_simt_dkdv(part: int, q, k, v, do, stats, causal: bool,
                   scale: float, kernel: str):
    """One dk/dv launch of the ``simt`` backward (``part`` `_DKDV`, `_DV`
    or `_DK`), after `flash_bwd_dq_cuda` on the same stream, reading its
    ``stats``; returns (dk, dv), the one not computed None."""
    b, L, h, kvh, d = _check_bwd(q, k, v, do, do, kernel)
    _check_part(part, d, kernel)
    _build.check_arg(kernel, "stats", stats, torch.float32, 4, q.device)
    if stats.shape != (2, b, h, L):
        raise ValueError(f"{kernel}: stats must be (2, {b}, {h}, {L}), got "
                         f"{tuple(stats.shape)}")
    dk = torch.empty_like(k) if part != _DV else None
    dv = torch.empty_like(v) if part != _DK else None
    fn = _build.launcher("flash_attention_bwd", "flash_bwd_dkdv_launch",
                         _BWD_DKDV_ARGTYPES)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 stats.data_ptr(), _build.data_ptr(dk), _build.data_ptr(dv),
                 _DTYPES[q.dtype], b, L, h, kvh, d, scale, int(causal), part,
                 torch.cuda.current_stream(q.device).cuda_stream), kernel)
    return dk, dv


def flash_bwd_dkdv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, stats: torch.Tensor, *,
                        causal: bool, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``simt`` backward's second launch, after `flash_bwd_dq_cuda`
    on the same stream, reading its ``stats``: returns (dk, dv) (B, L,
    KVH, D) in k's dtype, each summed over the KV head's query heads.  Not
    at a head dim of `SPLIT_DKDV_HEAD_DIMS` (its dk and dv are
    `flash_bwd_dk_cuda` and `flash_bwd_dv_cuda`)."""
    return _bwd_simt_dkdv(_DKDV, q, k, v, do, stats, causal, scale,
                          "flash_bwd_dkdv")


def flash_bwd_dv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, stats: torch.Tensor, *,
                      causal: bool, scale: float) -> torch.Tensor:
    """At a head dim of `SPLIT_DKDV_HEAD_DIMS`, the ``simt`` backward's
    second launch (after `flash_bwd_dq_cuda`, reading its ``stats``): dv
    alone (B, L, KVH, D) in k's dtype, summed over the KV head's query
    heads (``v`` is checked, not read)."""
    return _bwd_simt_dkdv(_DV, q, k, v, do, stats, causal, scale,
                          "flash_bwd_dv")[1]


def flash_bwd_dk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, stats: torch.Tensor, *,
                      causal: bool, scale: float) -> torch.Tensor:
    """At a head dim of `SPLIT_DKDV_HEAD_DIMS`, the ``simt`` backward's
    third launch (after `flash_bwd_dq_cuda`, reading its ``stats``): dk
    alone (B, L, KVH, D) in k's dtype, summed over the KV head's query
    heads."""
    return _bwd_simt_dkdv(_DK, q, k, v, do, stats, causal, scale,
                          "flash_bwd_dk")[0]


def _check_bwd_tc(q, k, v, o, do, lse, kernel: str, dtype: torch.dtype
                  ) -> tuple[int, int, int, int, int]:
    """`_check_bwd` for a tensor-core route (``wgmma`` bf16, ``tf32x3``
    float32): that dtype, D one of `WGMMA_HEAD_DIMS`, and the forward's
    (B, H, L) float32 ``lse``."""
    b, L, h, kvh, d = _check_bwd(q, k, v, o, do, kernel, WGMMA_HEAD_DIMS)
    if q.dtype != dtype:
        raise ValueError(f"{kernel}: needs {dtype} and D in "
                         f"{WGMMA_HEAD_DIMS} (got {q.dtype}, {d})")
    _check_lse(lse, kernel, b, h, L, q.device)
    return b, L, h, kvh, d


def _bwd_tc_dq(src: str, dtype: torch.dtype, q, k, v, o, do, lse,
               causal: bool, scale: float):
    """The first launch of the tensor-core backward ``csrc/<src>.cu``:
    returns dq and the float32 (B, H, L) Δ = rowsum(do ∘ o)."""
    kernel = f"{src}_dq"
    b, L, h, kvh, d = _check_bwd_tc(q, k, v, o, do, lse, kernel, dtype)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    fn = _build.launcher(src, f"{src}_dq_launch", _BWD_WGMMA_ARGTYPES)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 delta.data_ptr(), b, L, h, kvh, d, scale, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream), kernel)
    return dq, delta


def _bwd_tc_dkdv(src: str, dtype: torch.dtype, part: int, q, k, v, do,
                 lse, delta, causal: bool, scale: float, kernel: str):
    """One dk/dv launch (``part`` `_DKDV`, `_DV` or `_DK`) of the
    tensor-core backward ``csrc/<src>.cu``, after its dq launch on the
    same stream, reading that launch's ``delta``; returns (dk, dv), the one
    not computed None."""
    b, L, h, kvh, d = _check_bwd_tc(q, k, v, do, do, lse, kernel, dtype)
    _check_part(part, d, kernel)
    _check_lse(delta, kernel, b, h, L, q.device, "delta")
    dk = torch.empty_like(k) if part != _DV else None
    dv = torch.empty_like(v) if part != _DK else None
    fn = _build.launcher(src, f"{src}_dkdv_launch", _BWD_WGMMA_DKDV_ARGTYPES)
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), _build.data_ptr(dk),
                 _build.data_ptr(dv), b, L, h, kvh, d, scale, int(causal),
                 part, torch.cuda.current_stream(q.device).cuda_stream),
              kernel)
    return dk, dv


def flash_bwd_wgmma_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool, scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``wgmma`` backward's first launch on ``q``'s stream: bf16 q, o
    and do (B, L, H, D), k and v (B, L, KVH, D), contiguous, and the
    forward's float32 (B, H, L) ``lse``.  Returns dq (bf16) and the float32
    (B, H, L) Δ = rowsum(do ∘ o) that `flash_bwd_wgmma_dkdv_cuda` reads."""
    return _bwd_tc_dq("flash_bwd_wgmma", torch.bfloat16, q, k, v, o, do, lse,
                      causal, scale)


def flash_bwd_wgmma_dkdv_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor, *,
                              causal: bool, scale: float
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``wgmma`` backward's second launch, after
    `flash_bwd_wgmma_dq_cuda` on the same stream, reading its ``delta``:
    returns (dk, dv) (B, L, KVH, D) in bf16, each summed over the KV head's
    query heads.  Not at a head dim of `SPLIT_DKDV_HEAD_DIMS` (its dk and
    dv are `flash_bwd_wgmma_dk_cuda` and `flash_bwd_wgmma_dv_cuda`)."""
    return _bwd_tc_dkdv("flash_bwd_wgmma", torch.bfloat16, _DKDV, q, k, v,
                        do, lse, delta, causal, scale,
                        "flash_bwd_wgmma_dkdv")


def flash_bwd_wgmma_dv_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool, scale: float) -> torch.Tensor:
    """At a head dim of `SPLIT_DKDV_HEAD_DIMS`, the ``wgmma`` backward's
    second launch (after `flash_bwd_wgmma_dq_cuda`): dv alone (B, L, KVH,
    D) in bf16, summed over the KV head's query heads (``v`` and ``delta``
    are checked, not read)."""
    return _bwd_tc_dkdv("flash_bwd_wgmma", torch.bfloat16, _DV, q, k, v, do,
                        lse, delta, causal, scale, "flash_bwd_wgmma_dv")[1]


def flash_bwd_wgmma_dk_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool, scale: float) -> torch.Tensor:
    """At a head dim of `SPLIT_DKDV_HEAD_DIMS`, the ``wgmma`` backward's
    third launch (after `flash_bwd_wgmma_dq_cuda`, reading its ``delta``):
    dk alone (B, L, KVH, D) in bf16, summed over the KV head's query
    heads."""
    return _bwd_tc_dkdv("flash_bwd_wgmma", torch.bfloat16, _DK, q, k, v, do,
                        lse, delta, causal, scale, "flash_bwd_wgmma_dk")[0]


def flash_bwd_tf32x3_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool, scale: float
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``tf32x3`` backward's first launch on ``q``'s stream: float32 q,
    o and do (B, L, H, D), k and v (B, L, KVH, D), contiguous, 16-byte
    aligned, D one of `WGMMA_HEAD_DIMS`, and the forward's float32 (B, H,
    L) ``lse``.  Returns dq and the float32 (B, H, L) Δ = rowsum(do ∘ o)
    that `flash_bwd_tf32x3_dkdv_cuda` reads."""
    return _bwd_tc_dq("flash_bwd_tf32x3", torch.float32, q, k, v, o, do,
                      lse, causal, scale)


def flash_bwd_tf32x3_dkdv_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, do: torch.Tensor,
                               lse: torch.Tensor, delta: torch.Tensor, *,
                               causal: bool, scale: float
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``tf32x3`` backward's second launch, after
    `flash_bwd_tf32x3_dq_cuda` on the same stream, reading its ``delta``:
    returns float32 (dk, dv) (B, L, KVH, D), each summed over the KV head's
    query heads.  Not at a head dim of `SPLIT_DKDV_HEAD_DIMS` (its dk and
    dv are `flash_bwd_tf32x3_dk_cuda` and `flash_bwd_tf32x3_dv_cuda`)."""
    return _bwd_tc_dkdv("flash_bwd_tf32x3", torch.float32, _DKDV, q, k, v,
                        do, lse, delta, causal, scale,
                        "flash_bwd_tf32x3_dkdv")


def flash_bwd_tf32x3_dv_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor, *,
                             causal: bool, scale: float) -> torch.Tensor:
    """At a head dim of `SPLIT_DKDV_HEAD_DIMS`, the ``tf32x3`` backward's
    second launch (after `flash_bwd_tf32x3_dq_cuda`): dv alone (B, L, KVH,
    D), summed over the KV head's query heads (``v`` and ``delta`` are
    checked, not read)."""
    return _bwd_tc_dkdv("flash_bwd_tf32x3", torch.float32, _DV, q, k, v, do,
                        lse, delta, causal, scale, "flash_bwd_tf32x3_dv")[1]


def flash_bwd_tf32x3_dk_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor, *,
                             causal: bool, scale: float) -> torch.Tensor:
    """At a head dim of `SPLIT_DKDV_HEAD_DIMS`, the ``tf32x3`` backward's
    third launch (after `flash_bwd_tf32x3_dq_cuda`, reading its
    ``delta``): dk alone (B, L, KVH, D), summed over the KV head's query
    heads."""
    return _bwd_tc_dkdv("flash_bwd_tf32x3", torch.float32, _DK, q, k, v, do,
                        lse, delta, causal, scale, "flash_bwd_tf32x3_dk")[0]


# Each backward route's launches: dq, then dk and dv (or dv and dk apart
# at `SPLIT_DKDV_HEAD_DIMS`); the routes of `LSE_BWD_ROUTES` take the
# forward's lse after q, k, v, o and do.
BWD_CUDA = {
    "wgmma": (flash_bwd_wgmma_dq_cuda, flash_bwd_wgmma_dkdv_cuda,
              flash_bwd_wgmma_dv_cuda, flash_bwd_wgmma_dk_cuda),
    "tf32x3": (flash_bwd_tf32x3_dq_cuda, flash_bwd_tf32x3_dkdv_cuda,
               flash_bwd_tf32x3_dv_cuda, flash_bwd_tf32x3_dk_cuda),
    "simt": (flash_bwd_dq_cuda, flash_bwd_dkdv_cuda, flash_bwd_dv_cuda,
             flash_bwd_dk_cuda)}
