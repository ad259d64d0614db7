"""Device-dispatching wrappers over the port's kernels.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the kernel's plain PyTorch version in `kernels.ref`.  There
is no fallback from one to the other.  ``LAUNCHES`` counts kernel launches
— incremented where a kernel is launched and nowhere else — so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.tiles import TiledGraph
from repro_torch.kernels import ref

LAUNCHES = {"fused_expand": 0, "cover_counts": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def fused_expand(tg: TiledGraph, frontier: torch.Tensor,
                 visited: torch.Tensor, seed: int, level: int) -> torch.Tensor:
    """One fused-BPT expansion level on a TiledGraph (rows padded to T)."""
    if _on_cuda(tg.prob, frontier, visited):
        from repro_torch.kernels.fused_expand import fused_expand_cuda
        out = fused_expand_cuda(tg.prob, tg.edge_id, tg.tile_src,
                                tg.dst_run_ptr, frontier, visited, seed,
                                level)
        LAUNCHES["fused_expand"] += 1
        return out
    return ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                tg.tile_dst, frontier, visited, seed, level)


def cover_counts(visited: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Marginal-gain counts summed over batches: (B, V, W) × (B, W) → (V,)."""
    if _on_cuda(visited, active):
        from repro_torch.kernels.coverage import cover_counts_cuda
        out = cover_counts_cuda(visited.contiguous(), active.contiguous())
        LAUNCHES["cover_counts"] += 1
        return out
    return ref.cover_counts_ref(visited, active)
