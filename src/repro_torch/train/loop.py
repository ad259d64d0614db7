"""Fault-tolerant training loop: checkpoint/restart, async writes, failure
injection, deterministic resume (the reference's ``train/loop.py``).

The restart contract: a run killed at any step and restarted from its
latest checkpoint ends with the same parameters as an uninterrupted run,
because the data cursor is the step (`data.pipeline.SyntheticLM`), the
weights are a function of the seed, and the step is deterministic (on
the card up to the embedding gradient's atomics).

A checkpoint holds ``(params, AdamWState)`` in the reference's layout
(`convert.lm_stacked_tree`: ``0/stacks/<i>/block<j>/…`` with the group
axis leading, moments the same way under ``1/.m`` and ``1/.v``), so
either package resumes from the other's checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch import device as device_lib
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models import common, model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.step import check_trainable, make_train_step


class SimulatedCrash(RuntimeError):
    pass


@dataclasses.dataclass
class TrainResult:
    params: model.LM
    opt_state: adamw.AdamWState
    losses: list
    resumed_from: Optional[int]
    steps_run: int
    step_seconds: list               # host clock per step, synchronised
    grad_norms: list


def _host_stack(ts: list) -> torch.Tensor:
    return torch.stack([t.detach().cpu() for t in ts])


def _shape_of(ts: list) -> torch.Tensor:
    return torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype,
                       device="meta")


def _state_tree(params: model.LM, opt: adamw.AdamWState, cfg: ModelConfig,
                stack=_host_stack):
    """``(params, opt)`` in the reference's layout, stacked by ``stack``
    (on the host by default: the checkpoint copies there anyway)."""
    def tree(named):
        return convert.lm_stacked_tree(named, cfg, stack)

    return (tree(adamw.named(params)),
            adamw.AdamWState(step=opt.step, m=tree(opt.m), v=tree(opt.v)))


def _restore(directory: str, params: model.LM, opt: adamw.AdamWState,
             cfg: ModelConfig):
    """Load the latest checkpoint (the reference's layout) into ``params``
    and a new optimizer state on their device; returns (state, step)."""
    named = adamw.named(params)
    (p_tree, o_tree), start = ckpt.restore(
        directory, _state_tree(params, opt, cfg, _shape_of))
    dev = opt.step.device
    with torch.no_grad():
        for name, t in convert.lm_named_leaves(p_tree, cfg).items():
            named[name].copy_(t)
    opt = adamw.AdamWState(
        step=o_tree.step.to(dev),
        m={k: t.to(dev) for k, t in
           convert.lm_named_leaves(o_tree.m, cfg).items()},
        v={k: t.to(dev) for k, t in
           convert.lm_named_leaves(o_tree.v, cfg).items()})
    return opt, start


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def train(cfg: ModelConfig, *, batch: int, seq_len: int, steps: int,
          lr: float = 3e-4, warmup: int = 10, seed: int = 0,
          checkpoint_dir: Optional[str] = None, ckpt_every: int = 10,
          async_ckpt: bool = True, num_microbatches: int = 1,
          crash_at_step: Optional[int] = None,
          log_every: int = 10, print_fn: Callable = print,
          device="cuda", clock: Optional[dict] = None) -> TrainResult:
    """Run (or resume) training from `model.init_params(cfg, seed,
    device)` with moments of the config's ``optimizer_state_dtype``:
    float32, as the reference's loop has them, but bf16 for the configs
    of 100 B parameters and more (qwen1.5-110b, nemotron-4-340b,
    deepseek-v3, maverick), whose moments the reference's loop keeps in
    float32 too; a cut of one fits one card only with bf16 moments.
    ``crash_at_step`` raises SimulatedCrash AFTER that step's update but
    BEFORE its checkpoint — the worst case.  ``clock``: as
    `make_train_step`'s."""
    dev = device_lib.resolve(device)
    check_trainable(cfg, dev)
    params = model.trainable(model.init_params(cfg, seed, dev))
    opt = adamw.init(params, common.dtype_of(cfg.optimizer_state_dtype))
    start = 0
    resumed = None
    if checkpoint_dir and ckpt.latest_step(checkpoint_dir) is not None:
        opt, start = _restore(checkpoint_dir, params, opt, cfg)
        resumed = start
        print_fn(f"[train] resumed from step {start}")

    lr_fn = adamw.cosine_schedule(lr, warmup, steps)
    step_fn = make_train_step(cfg, lr_fn, num_microbatches, clock=clock)

    data = SyntheticLM(cfg, batch, seq_len, seed=seed + 1)
    prefetch = Prefetcher(data, start_step=start)
    losses, seconds, norms = [], [], []
    writer = None
    try:
        for step in range(start, steps):
            got_step, b = prefetch.get()
            assert got_step == step, (got_step, step)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, _to_device(b, dev))
            loss = float(metrics["loss"])         # synchronises the step
            seconds.append(time.perf_counter() - t0)
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            if step % log_every == 0:
                print_fn(f"[train] step {step:5d} loss {loss:.4f} "
                         f"gnorm {norms[-1]:.3f}")
            if checkpoint_dir and (step + 1) % ckpt_every == 0:
                if writer is not None:
                    writer.join()                 # previous async write
                writer = ckpt.save(checkpoint_dir, step + 1,
                                   _state_tree(params, opt, cfg),
                                   blocking=not async_ckpt)
            if crash_at_step is not None and step == crash_at_step:
                raise SimulatedCrash(f"injected crash after step {step}")
    finally:
        prefetch.close()
        if writer is not None:
            writer.join()
    return TrainResult(params=params, opt_state=opt, losses=losses,
                       resumed_from=resumed, steps_run=steps - start,
                       step_seconds=seconds, grad_norms=norms)


def train_with_restarts(cfg: ModelConfig, *, steps: int, checkpoint_dir: str,
                        crash_schedule: tuple = (), **kw) -> TrainResult:
    """`train`, restarted after every SimulatedCrash — the single-process
    analogue of a cluster controller rescheduling a failed job."""
    crashes = list(crash_schedule)
    while True:
        crash_at = crashes.pop(0) if crashes else None
        try:
            return train(cfg, steps=steps, checkpoint_dir=checkpoint_dir,
                         crash_at_step=crash_at, **kw)
        except SimulatedCrash:
            continue
