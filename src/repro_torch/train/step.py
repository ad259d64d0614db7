"""Training step: microbatched gradient accumulation + AdamW (the
reference's ``train/step.py``).

One step, on one device or on a mesh (``mesh=``,
`distributed.comm.Mesh`, one process a position): the reference's
sharded step (ZeRO-3, `distributed.fsdp`).  ``params`` holds this rank's
shards, each microbatch's rows are split over every rank
(`fsdp.local_rows`), each layer is gathered where it runs, and each
microbatch's gradient is reduce-scattered into accumulators of the
shards' shape, as the reference's ``constrain_params`` makes GSPMD do.
One device is the one-rank case (`fsdp.one_rank`): every leaf whole
and used as it is (its gradient reaches the accumulators through a hook
on the leaf), every collective its input.  With ``num_microbatches`` M > 1 the global
batch is cut into M chunks along its first axis (the reference's
reshape), so the live activations are one microbatch's; gradients then
accumulate in float32 whatever the parameters' dtype, and gradients and
loss are divided by M.  With M = 1 the gradients stay in the parameters'
dtype.  AdamW updates the shards; the gradient norm is the whole
model's.  Each GQA attention runs the flash kernel forward and its
hand-written gradient (`kernels.ops.flash_attention`); MLA, the SSD
mixer and the MoE router, dispatch and experts run plain PyTorch
differentiated by autograd; under ``cfg.remat`` each layer's forward
(its gathers included) runs again in the backward.

Every family trains: the dense archs, phi-3-vision with its patches,
musicgen with its codebooks, the MoE archs (the loss adds 0.01 times the
Switch aux loss), MLA, mamba2's SSD stack and zamba2's hybrid stack, on
the card in float32 or bf16 alike (nemotron's head dim 192 too: the
``wgmma`` backward in bf16, the ``tf32x3`` one in float32).  On a CUDA device
a config whose attention no backward kernel takes (a head dim such as 48
or 256, which no registry arch has) is refused up front
(`check_trainable`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.distributed import fsdp
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common, model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def check_trainable(cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError for a config this port cannot train on
    ``device``: on a CUDA device, flash attention (GQA: the dense and MoE
    archs but MLA, zamba2's shared block) at a head dim that the backward
    route of its dtype (`flash_attention.route_bwd`) does not take — the
    backward would refuse it only at its first call.  Every arch of the
    registry passes in float32 and in bf16; every config passes on the
    CPU, where the backward is its plain version."""
    if device is None or torch.device(device).type != "cuda":
        return
    if cfg.family == "ssm" or cfg.attention == "mla" or not cfg.head_dim:
        return
    dtype = common.dtype_of(cfg.dtype)
    r = fa.route_bwd(dtype, 2, cfg.head_dim)     # any training length > 1
    if cfg.head_dim not in fa.bwd_head_dims(r):
        raise NotImplementedError(
            f"training {cfg.name} ({cfg.dtype}) on the card: no backward "
            f"kernel takes its head dim {cfg.head_dim} (the {r} route takes "
            f"{fa.bwd_head_dims(r)}; the wgmma and tf32x3 routes take "
            f"bf16 and float32)")


@contextlib.contextmanager
def _phase(clock: Optional[dict], name: str, device: torch.device):
    """Add the seconds of the block to ``clock[name]`` (device work
    included: synchronised on both sides); nothing without a clock."""
    if clock is None:
        yield
        return
    device_lib.synchronize(device)
    t0 = time.perf_counter()
    yield
    device_lib.synchronize(device)
    clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0


def make_train_step(cfg: ModelConfig, lr_fn: Callable,
                    num_microbatches: int = 1, weight_decay: float = 0.1,
                    max_grad_norm: float = 1.0,
                    clock: Optional[dict] = None, mesh=None):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    {"loss", "grad_norm", "lr"}); ``params`` is a trainable `model.LM`
    (`model.trainable`), updated in place, ``batch`` the global batch, a
    dict of tensors on its device (on a mesh the same on every rank).
    With a ``mesh``, ``params`` holds this rank's shards
    (`fsdp.Layout.shard`); without one, the whole model (module
    docstring).  After a step, the layout's ``sink`` holds this rank's
    shards of its gradient (before clipping) until the next step.  With a
    ``clock`` dict, each step adds its forward, backward and optimizer
    seconds to it.  Every config of the registry trains; on a CUDA device
    `check_trainable` says which cannot, and `loop.train` asks it before
    it builds the model."""
    M = num_microbatches

    def train_step(params: model.LM, opt_state: adamw.AdamWState,
                   batch: dict):
        layout = (fsdp.one_rank(params) if mesh is None
                  else fsdp.layout_of(params, mesh))
        on = layout.mesh
        named = adamw.named(params)
        dev = next(iter(named.values())).device
        rows = fsdp.local_rows(batch, on, M)
        layout.sink = None                      # the last step's gradient
        layout.sink = {n: torch.zeros(p.shape, dtype=torch.float32
                                      if M > 1 else p.dtype, device=dev)
                       for n, p in named.items()}
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(M):
            mb = {k: x.reshape(M, x.shape[0] // M, *x.shape[1:])[i]
                  for k, x in rows.items()}
            with _phase(clock, "forward", dev):
                share = model.loss_fn(params, cfg, mb, mesh=on)[0]
            with _phase(clock, "backward", dev):
                share.backward()
            loss = loss + on.psum(share.detach(), on.axis_names)
            del share
        grads = layout.sink
        if M > 1:
            for g in grads.values():
                g.div_(M)
            loss = loss / M
        lr = lr_fn(opt_state.step)
        with _phase(clock, "optimizer", dev):
            params, opt_state, gnorm = adamw.update(
                params, grads, opt_state, lr=lr, weight_decay=weight_decay,
                max_grad_norm=max_grad_norm, layout=layout)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step
