"""Hand-rolled AdamW (the reference's ``optim/adamw.py``).

A parameter tree is an `nn.Module` (its named parameters) or a dict of name
→ tensor; gradients and the moments ``m`` and ``v`` are dicts keyed by the
same names.  The arithmetic is the reference's, per leaf in float32, cast
back to each leaf's dtype, with weight decay on every leaf.  `update`
writes the parameters and moments in place (under ``no_grad``) where the
reference returns new trees: at llama3.2-3b's width a second copy of the
weights and float32 moments would be 33.6 GiB.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor               # int32 scalar, steps taken
    m: dict
    v: dict


def named(tree) -> dict:
    """The tree as a dict of name → tensor."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def init(params, state_dtype=torch.float32) -> AdamWState:
    """Zero moments of ``state_dtype``, one per parameter, on its device."""
    p = named(params)
    dev = next(iter(p.values())).device

    def zeros():
        return {k: torch.zeros(t.shape, dtype=state_dtype, device=t.device)
                for k, t in p.items()}

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 sums of squares.  With
    a `distributed.fsdp.Layout` the leaves are this rank's shards: each
    leaf's sum is summed over the axes that leaf is split over (one
    all-reduce per axis for all the leaves split alike), so that every
    element counts once and a replicated leaf is not summed at all; the
    leaves' sums are then added in the tree's order, as on one device."""
    leaves = named(tree)
    sums = {k: x.float().square().sum() for k, x in leaves.items()}
    if layout is not None:
        groups: dict[tuple, list] = {}
        for k in leaves:
            groups.setdefault(layout.sharded_axes(k), []).append(k)
        for axes, names in groups.items():
            if not axes:
                continue
            total = layout.mesh.psum(torch.stack([sums[k] for k in names]),
                                     axes)
            sums.update(zip(names, total.unbind(0)))
    return torch.sqrt(sum(sums.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in their
    own dtypes; the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return ({k: (g.float() * scale).to(g.dtype)
             for k, g in named(grads).items()}, norm)


def update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, max_grad_norm=1.0, layout=None):
    """One AdamW step on clipped gradients, the parameters and moments
    updated in place.  Returns (params, state, grad_norm before
    clipping).  With a `distributed.fsdp.Layout`, every tree holds this
    rank's shards: the arithmetic is elementwise, and the norm is the
    whole model's (`global_norm`)."""
    p_named, g_named = named(params), named(grads)
    gnorm = global_norm(g_named, layout)
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    decay = 1.0 - lr * weight_decay
    with torch.no_grad():
        for name, p in p_named.items():
            g = g_named[name]
            g32 = (g.float() * scale).to(g.dtype).float()
            m, v = state.m[name], state.v[name]
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32.square()
            del g32
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            m.copy_(m32)
            v.copy_(v32)
            del m32, v32
            p.copy_(p.float() * decay - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """lr(step): linear warmup from 0 over ``warmup`` steps, then a cosine
    down to ``min_frac · base_lr`` at ``total``; float32."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr
