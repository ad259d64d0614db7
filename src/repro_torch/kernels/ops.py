"""Device-dispatching wrappers over the port's kernels.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the kernel's plain PyTorch version in `kernels.ref`.  There
is no fallback from one to the other.  ``LAUNCHES`` counts kernel launches
— incremented where a kernel is launched and nowhere else — so a run can
show that its path went through the kernels.

The tile kernels take an optional ``tile_ids``: ascending int32 ids of the
tiles to walk (the sparse frontier's compacted list).  Each walks the
layout's slot list (`core.tiles.ic_slot_list`, `q_slot_list`,
`lt_slot_list`, built once per stack), on the card and in its plain
version alike, so the CPU runs exercise the list too;
``fused_expand_slots`` and ``lt_select_expand_slots`` take a list that has
no stack (a row shard's, `graph.partition`).  ``fused_expand_q``
reads the quantised layout's uint8 stack (`core.tiles.quantized`).
``cover_counts`` and ``cover_counts_multi`` launch one kernel
(``csrc/coverage.cu``) for one or Q active masks per batch;
``LAUNCHES["cover_counts"]`` counts both, ``cover_counts_multi`` the
second alone.  ``flash_attention`` serves the LM substrate's
prefill and decode through four kernels chosen by shape
(`kernels.flash_attention.route`); ``LAUNCHES["flash_attention"]`` counts
them all, ``flash_wgmma``, ``flash_decode``, ``flash_tf32x3`` and
``flash_simt`` each route.  When one of its inputs requires a gradient,
``flash_attention`` runs the same forward inside an autograd rule whose
backward is ``flash_attention_bwd``: two kernel launches (three at head
dim 192, `kernels.flash_attention.bwd_launches`) of the route
`kernels.flash_attention.route_bwd` picks (``wgmma`` or ``tf32x3``, which
read the log-sum-exp their forward wrote, or ``simt``), each counted in
``LAUNCHES["flash_bwd"]`` and in ``flash_bwd_<route>``.

Meta tensors (the dry-run, `launch.cost_analysis`) take a third branch
of every wrapper: it launches nothing, leaves ``LAUNCHES`` as it is,
returns empty meta tensors of the kernel's output shapes and hands the
kernel's work — operations and HBM bytes, by the formulas of the bound
column of PERF.md §6 (`kernels.work`) — to every counter in
``COST_SINKS``.  It is no fallback: a meta tensor computes nothing, and a
CPU or CUDA tensor never reaches it.  Tensors on mixed devices raise.
"""
from __future__ import annotations

import torch

from repro_torch.core import tiles
from repro_torch.core.tiles import SlotList, TiledGraph
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, work

LAUNCHES = {"fused_expand": 0, "cover_counts": 0, "lt_select_expand": 0,
            "flash_attention": 0, "fused_expand_q": 0,
            "flash_wgmma": 0, "flash_decode": 0, "flash_simt": 0,
            "cover_counts_multi": 0, "flash_bwd": 0, "flash_bwd_wgmma": 0,
            "flash_bwd_simt": 0, "flash_tf32x3": 0, "flash_bwd_tf32x3": 0}


# Callables (kernel name, operations, bytes) that a meta call reports to.
COST_SINKS: list = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _where(*tensors: torch.Tensor) -> str:
    """``"cuda"``, ``"cpu"`` or ``"meta"``: the one device type of
    ``tensors``; raises for mixed or other devices."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) == 1 and kinds <= {"cuda", "cpu", "meta"}:
        return kinds.pop()
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def _report(name: str, ops: float, nbytes: float) -> None:
    """A meta call's work, handed to every counter of ``COST_SINKS``."""
    for sink in COST_SINKS:
        sink(name, float(ops), float(nbytes))


def _meta_like(t: torch.Tensor, shape=None, dtype=None) -> torch.Tensor:
    return torch.empty(tuple(t.shape) if shape is None else tuple(shape),
                       dtype=dtype or t.dtype, device="meta")


def fused_expand(tg: TiledGraph, frontier: torch.Tensor,
                 visited: torch.Tensor, seed: int, level: int,
                 tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """One fused-BPT IC expansion level on a TiledGraph (rows padded to T),
    over every tile or the listed ones."""
    return fused_expand_slots(tiles.ic_slot_list(tg), frontier, visited,
                              seed, level, tile_ids)


def fused_expand_slots(slots: SlotList, frontier: torch.Tensor,
                       visited: torch.Tensor, seed: int, level: int,
                       tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """`fused_expand` on an IC slot list itself — a layout's, or a row
    shard's (`graph.partition.ShardLayout`: the global frontier in, the
    shard's rows out), which has no stack to look it up by."""
    where = _where(slots.src_row, frontier, visited)
    if where == "meta":
        _report("fused_expand", *work.slot_expand(slots, frontier, visited,
                                                  "ic"))
        return _meta_like(visited)
    if where == "cuda":
        from repro_torch.kernels.fused_expand import fused_expand_cuda
        out = fused_expand_cuda(slots, frontier, visited, seed, level,
                                tile_ids=tile_ids)
        LAUNCHES["fused_expand"] += 1
        return out
    return ref.fused_expand_slots_ref(slots, frontier, visited, seed, level,
                                      tile_ids=tile_ids)


def lt_select_expand(tg: TiledGraph, cb: torch.Tensor, frontier: torch.Tensor,
                     visited: torch.Tensor, u: torch.Tensor,
                     tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """One fused-BPT LT expansion level: ``cb`` the selection-CDF prefixes
    in ``tg``'s layout, ``u`` the traversal's uniform table; over every
    tile or the listed ones."""
    return lt_select_expand_slots(tiles.lt_slot_list(tg, cb), frontier,
                                  visited, u, tile_ids)


def lt_select_expand_slots(slots: SlotList, frontier: torch.Tensor,
                           visited: torch.Tensor, u: torch.Tensor,
                           tile_ids: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """`lt_select_expand` on an LT slot list itself (as
    `fused_expand_slots`); ``u``'s rows align with ``visited``'s."""
    where = _where(slots.src_row, frontier, visited, u)
    if where == "meta":
        _report("lt_select_expand", *work.slot_expand(
            slots, frontier, visited, "lt", u))
        return _meta_like(visited)
    if where == "cuda":
        from repro_torch.kernels.lt_select_expand import \
            lt_select_expand_cuda
        out = lt_select_expand_cuda(slots, frontier, visited, u,
                                    tile_ids=tile_ids)
        LAUNCHES["lt_select_expand"] += 1
        return out
    return ref.lt_select_expand_slots_ref(slots, frontier, visited, u,
                                          tile_ids=tile_ids)


def fused_expand_q(tg: TiledGraph, q8: torch.Tensor, frontier: torch.Tensor,
                   visited: torch.Tensor, seed: int, level: int,
                   tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """One quantised IC expansion level: ``q8`` the (nt, T, T) uint8
    thresholds in ``tg``'s layout (`core.tiles.quantized`), over every
    tile or the listed ones (the counterpart of the reference's
    ``fused_expand_q_gathered``: each listed tile draws with its own id)."""
    _where(q8, tg.tile_src, frontier, visited)
    return fused_expand_q_slots(tiles.q_slot_list(tg, q8), frontier, visited,
                                seed, level, tile_ids)


def fused_expand_q_slots(slots: SlotList, frontier: torch.Tensor,
                         visited: torch.Tensor, seed: int, level: int,
                         tile_ids: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """`fused_expand_q` on a quantised slot list itself (as
    `fused_expand_slots`)."""
    where = _where(slots.src_row, frontier, visited)
    if where == "meta":
        _report("fused_expand_q", *work.slot_expand(slots, frontier, visited,
                                                    "q"))
        return _meta_like(visited)
    if where == "cuda":
        from repro_torch.kernels.fused_expand_q import fused_expand_q_cuda
        out = fused_expand_q_cuda(slots, frontier, visited, seed, level,
                                  tile_ids=tile_ids)
        LAUNCHES["fused_expand_q"] += 1
        return out
    return ref.fused_expand_q_slots_ref(slots, frontier, visited, seed, level,
                                        tile_ids=tile_ids)


def cover_counts(visited: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Marginal-gain counts summed over batches: (B, V, W) × (B, W) → (V,)
    (`cover_counts_multi` with one active mask per batch)."""
    where = _where(visited, active)
    if where == "meta":
        _report("cover_counts", *work.cover_counts(visited, 1))
        return _meta_like(visited, visited.shape[1:2], torch.int32)
    if where == "cuda":
        from repro_torch.kernels.coverage import cover_counts_cuda
        out = cover_counts_cuda(visited.contiguous(),
                                active.contiguous()[:, None])
        LAUNCHES["cover_counts"] += 1
        return out[0]
    return ref.cover_counts_ref(visited, active)


def cover_counts_multi(visited: torch.Tensor,
                       active_q: torch.Tensor) -> torch.Tensor:
    """Marginal-gain counts for Q active masks per batch, summed over
    batches, in one pass over ``visited``: (B, V, W) × (B, Q, W) → (Q, V)."""
    where = _where(visited, active_q)
    if where == "meta":
        q = active_q.shape[1]
        _report("cover_counts", *work.cover_counts(visited, q))
        return _meta_like(visited, (q, visited.shape[1]), torch.int32)
    if where == "cuda":
        from repro_torch.kernels.coverage import cover_counts_cuda
        out = cover_counts_cuda(visited.contiguous(), active_q.contiguous())
        LAUNCHES["cover_counts"] += 1
        LAUNCHES["cover_counts_multi"] += 1
        return out
    return ref.cover_counts_multi_ref(visited, active_q)


def _flash_forward(q, k, v, causal: bool, scale: float, kv_offset: int,
                   want_lse: bool = False):
    """The forward on batched (B, Lq, H, D) tensors: a route's kernel on
    the card (counted), the plain version on the CPU, the work reported on
    meta.  Returns the output and, with ``want_lse`` (asked where the
    route is ``wgmma``, ``tf32x3`` or ``decode``), each row's float32 (B, H,
    Lq) log-sum-exp, else None.  A decode row that sees no key (a
    sequence-parallel rank whose keys all lie past ``kv_offset``) has
    output 0 and log-sum-exp -inf, and launches nothing."""
    b, lq, h, d = q.shape
    where = _where(q, k, v)
    r = fa.route(q.dtype, b, lq, k.shape[1], h, k.shape[2], d, causal)
    lse = None
    if r == "decode" and fa.visible_keys(k.shape[1], causal, kv_offset) < 1:
        if want_lse:
            lse = torch.full((b, h, lq), float("-inf"), dtype=torch.float32,
                             device=q.device)
        return torch.zeros_like(q), lse
    if where == "meta":
        _report(f"flash_{r}", *work.flash_forward(q, k, causal, kv_offset,
                                                  want_lse))
        if want_lse:
            lse = _meta_like(q, (b, h, lq), torch.float32)
        return _meta_like(q), lse
    if where == "cuda":
        kw = {}
        if want_lse:
            lse = kw["lse"] = torch.empty((b, h, lq), dtype=torch.float32,
                                          device=q.device)
        out = fa.CUDA_ROUTES[r](q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, scale=scale,
                                kv_offset=kv_offset, **kw)
        LAUNCHES[f"flash_{r}"] += 1
        LAUNCHES["flash_attention"] += 1
        return out, lse
    if want_lse:
        lse = ref.flash_attention_lse_ref(q, k, causal=causal, scale=scale,
                                          kv_offset=kv_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_offset=kv_offset), lse


class _FlashAttention(torch.autograd.Function):
    """`_flash_forward` with the backward kernels as its gradient; it saves
    q, k, v, the output and, where the backward's route is ``wgmma`` or
    ``tf32x3``, the log-sum-exp the forward wrote (under an activation
    checkpoint, autograd drops them and recomputes the forward, which writes
    it again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, causal=ctx.causal,
                                         scale=ctx.scale, lse=lse)
        return dq, dk, dv, None, None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The training forward of batched tensors (Lq == Lk, ``kv_offset``
    0), outside autograd: the output, and what `flash_attention_bwd`
    reads besides it — the float32 (B, H, L) log-sum-exp where
    `flash_attention.route_bwd` picks ``wgmma`` or ``tf32x3`` (the forward
    kernel writes it), None where it picks ``simt``."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    want = fa.route_bwd(q.dtype, q.shape[1],
                        q.shape[-1]) in fa.LSE_BWD_ROUTES
    return _flash_forward(q, k, v, causal, scale, 0, want_lse=want)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_offset: int = 0, return_lse: bool = False):
    """Blocked online-softmax attention (the LM substrate's prefill and
    decode): q (B, Lq, H, D), k and v (B, Lk, KVH, D), query head ``h``
    reading KV head ``h // (H // KVH)``; the reference's unbatched
    (Lq, H, D) layout is taken too.  Query ``i`` attends keys up to
    ``i + kv_offset`` under ``causal``.  Differentiable when Lq == Lk and
    ``kv_offset`` is 0 (the training forward); a call that needs a
    gradient anywhere else raises.  A call without a gradient writes no
    log-sum-exp, unless ``return_lse`` asks for it on the ``decode`` route
    (Lq == 1, no gradient): then it returns (out, each row's float32
    (B, H, 1) natural log-sum-exp, -inf where no key is visible), what a
    sequence-parallel decode merges across ranks."""
    unbatched = q.dim() == 3
    if unbatched:
        q, k, v = q[None], k[None], v[None]
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must all be "
                         "(Lq|Lk, H, D) or all (B, Lq|Lk, H, D)")
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if return_lse:
        if q.shape[1] != 1 or (torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v))):
            raise ValueError("flash_attention: return_lse takes the decode "
                             "route (Lq 1) without a gradient")
        out, lse = _flash_forward(q, k, v, causal, scale, kv_offset, True)
        return (out[0], lse[0]) if unbatched else (out, lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_offset or q.shape[1] != k.shape[1]:
            raise ValueError("flash_attention: a gradient needs Lq == Lk "
                             f"and kv_offset 0 (got {q.shape[1]}, "
                             f"{k.shape[1]}, {kv_offset})")
        out = _FlashAttention.apply(q, k, v, causal, scale)
    else:
        out = _flash_forward(q, k, v, causal, scale, kv_offset)[0]
    return out[0] if unbatched else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None,
                        lse: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` (Lq == Lk, ``kv_offset`` 0) given
    its output ``o``, the output's gradient ``do`` and what
    `flash_attention_fwd` returns beside ``o``: on the card two launches of
    the route `flash_attention.route_bwd` picks (three at a head dim of
    `flash_attention.SPLIT_DKDV_HEAD_DIMS`: dq, dv, dk), the ``wgmma`` and
    ``tf32x3`` ones reading the forward's (B, H, L) log-sum-exp ``lse``
    (required there; the ``simt`` route recomputes it and ignores one
    given); on the CPU `ref.flash_attention_bwd_ref` of the same route; on
    meta tensors each launch's share of the work
    (`work.flash_backward_launches`)."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    r = fa.route_bwd(q.dtype, q.shape[1], q.shape[-1])
    reads_lse = r in fa.LSE_BWD_ROUTES
    if reads_lse and lse is None:
        raise ValueError(f"flash_attention_bwd: the {r} route reads the "
                         "forward's log-sum-exp; pass lse "
                         "(flash_attention_fwd returns it)")
    where = _where(q, k, v, o, do)
    if where == "meta":
        for part in work.flash_backward_launches(q, k, causal):
            _report(f"flash_bwd_{r}", *part)
        return _meta_like(q), _meta_like(k), _meta_like(v)
    if where == "cuda":
        q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
        kw = dict(causal=causal, scale=scale)
        dq_fn, dkdv, dv_fn, dk_fn = fa.BWD_CUDA[r]
        if reads_lse:
            lse = lse.contiguous()
            dq, delta = dq_fn(q, k, v, o, do, lse, **kw)
            read = (lse, delta)         # what the dk and dv launches read
        else:
            dq, stats = dq_fn(q, k, v, o, do, **kw)
            read = (stats,)
        _count_bwd(r)
        if q.shape[-1] in fa.SPLIT_DKDV_HEAD_DIMS:
            dv = dv_fn(q, k, v, do, *read, **kw)
            _count_bwd(r)
            dk = dk_fn(q, k, v, do, *read, **kw)
        else:
            dk, dv = dkdv(q, k, v, do, *read, **kw)
        _count_bwd(r)
        return dq, dk, dv
    return ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       scale=scale,
                                       lse=lse if reads_lse else None)


def _count_bwd(r: str) -> None:
    LAUNCHES["flash_bwd"] += 1
    LAUNCHES[f"flash_bwd_{r}"] += 1
