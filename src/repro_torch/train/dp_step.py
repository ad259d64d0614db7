"""Data-parallel training step with an int8-compressed gradient all-reduce
(the reference's ``train/dp_step.py``), over `distributed.comm.Mesh`.

Every rank of the ``axis`` holds the whole model and optimizer state
(replicated: the same seed gives the same weights) and takes its own
shard of the global batch (rows ``r · B/n`` to ``(r + 1) · B/n`` on
position ``r``, the reference's ``P(axis)``).  The gradient is reduced
either exactly (a float32 mean) or compressed (`optim.compress`: int8
values summed as int32, error feedback), and every rank applies the same
AdamW update.  The residual of error feedback stays on its rank.  Every
family of the registry trains here as in `train.step` (the MoE aux loss is
in each rank's loss).
"""
from __future__ import annotations

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compress
from repro_torch.train.step import check_trainable


def make_dp_train_step(cfg: ModelConfig, lr_fn, mesh, axis: str = "data",
                       compressed: bool = True, weight_decay: float = 0.1):
    """Returns (step_fn, init_residual).  ``step_fn(params, opt, err,
    batch)`` → (params, opt, err, {"loss", "grad_norm"}) on each rank of
    ``axis``: ``batch`` is the global batch (the rank takes its shard),
    ``err`` the rank's float32 residual (`init_residual(params)`: zeros
    like each parameter); ``loss`` is the mean over the axis.  Every family
    trains (`train.step`); on CUDA ranks `check_trainable` refuses what no
    backward kernel takes."""
    check_trainable(cfg, mesh.device)
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)

    def step_fn(params, opt_state: adamw.AdamWState, err: dict,
                batch: dict):
        shard = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[r]
                 for k, x in batch.items()}
        named = adamw.named(params)
        loss = model.loss_fn(params, cfg, shard)[0]
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        g = {k: torch.zeros_like(p) if gi is None else gi
             for (k, p), gi in zip(named.items(), grads)}
        loss = mesh.psum(loss.detach(), axis) / n
        if compressed:
            g_hat, err = compress.compressed_psum(
                {k: gi.float() + err[k] for k, gi in g.items()}, mesh, axis)
        else:
            g_hat = {k: mesh.psum(gi.float(), axis) / n
                     for k, gi in g.items()}
        lr = lr_fn(opt_state.step)
        params, opt_state, gnorm = adamw.update(
            params, g_hat, opt_state, lr=lr, weight_decay=weight_decay)
        return params, opt_state, err, {"loss": loss, "grad_norm": gnorm}

    def init_residual(params) -> dict:
        return {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
                for k, p in adamw.named(params).items()}

    return step_fn, init_residual
