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

On a mesh (``mesh=``, one process a position, `distributed.fsdp`) each
rank draws the one-device weights and keeps its shards as it goes,
takes its rows of the global batch (which every rank draws alike, from
the step), and trains its shards.  A checkpoint is the same file a
one-device run writes: every leaf is gathered, rank 0 writes, and the
others wait at a barrier; a restore reads the file on every rank and
keeps the rank's slices, so sharded and one-device runs of either
package resume from each other's checkpoints.  One device is the mesh
of one rank (`comm.Mesh` with ``alone``): it holds every leaf whole and
may write asynchronously, as no rank waits for it.
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
from repro_torch.distributed import comm, fsdp
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
    peak_gib: Optional[float] = None  # this process's peak device memory


def _host_stack(ts: list) -> torch.Tensor:
    return torch.stack([t.detach().cpu() for t in ts])


def _shape_of(ts: list) -> torch.Tensor:
    return torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype,
                       device="meta")


def _state_tree(params: dict, opt: adamw.AdamWState, cfg: ModelConfig,
                stack=_host_stack):
    """``(params, opt)`` (named leaves) in the reference's layout, stacked
    by ``stack`` (on the host by default: the checkpoint copies there
    anyway)."""
    def tree(named):
        return convert.lm_stacked_tree(named, cfg, stack)

    return (tree(params),
            adamw.AdamWState(step=opt.step, m=tree(opt.m), v=tree(opt.v)))


def _full_state(params: model.LM, opt: adamw.AdamWState, layout):
    """(named parameters, optimizer state) at full size on the host, on
    rank 0 (every leaf gathered, a collective on every rank; the other
    ranks keep nothing)."""
    keep = layout.mesh.rank == 0

    def full(tree):
        out = {}
        for k, t in tree.items():
            t = layout.full(k, t.detach())
            if keep:
                out[k] = t.cpu()
        return out

    return full(adamw.named(params)), adamw.AdamWState(
        step=opt.step, m=full(opt.m), v=full(opt.v))


def _save(directory: str, step: int, params, opt, cfg, layout, blocking):
    """Write the checkpoint of ``step`` (rank 0; on a mesh of several
    ranks blocking, the others waiting); returns the writer thread of an
    async write."""
    named, opt = _full_state(params, opt, layout)
    writer = None
    if layout.mesh.rank == 0:
        writer = ckpt.save(directory, step, _state_tree(named, opt, cfg),
                           blocking=blocking or fsdp.mesh_size(
                               layout.mesh) > 1)
    layout.mesh.barrier()
    return writer


def _restore(directory: str, params: model.LM, opt: adamw.AdamWState,
             cfg: ModelConfig, layout):
    """Load the latest checkpoint (the reference's layout) into ``params``
    and a new optimizer state on their device (this rank's slices of
    each leaf); returns (state, step)."""
    named = adamw.named(params)

    def shapes(tree):           # full-size meta tensors of the tree's leaves
        return {k: torch.empty(layout.shapes[k], dtype=t.dtype,
                               device="meta")
                for k, t in tree.items()}

    moments = adamw.AdamWState(step=opt.step, m=shapes(opt.m),
                               v=shapes(opt.v))
    (p_tree, o_tree), start = ckpt.restore(
        directory, _state_tree(shapes(named), moments, cfg, _shape_of))
    dev = opt.step.device

    with torch.no_grad():
        for name, t in convert.lm_named_leaves(p_tree, cfg).items():
            named[name].copy_(layout.local(name, t))
    opt = adamw.AdamWState(
        step=o_tree.step.to(dev),
        m={k: layout.local(k, t).to(dev) for k, t in
           convert.lm_named_leaves(o_tree.m, cfg).items()},
        v={k: layout.local(k, t).to(dev) for k, t in
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
          device="cuda", clock: Optional[dict] = None,
          mesh=None) -> TrainResult:
    """Run (or resume) training from `model.init_params(cfg, seed,
    device)` with moments of the config's ``optimizer_state_dtype``:
    float32, as the reference's loop has them, but bf16 for the configs
    of 100 B parameters and more (qwen1.5-110b, nemotron-4-340b,
    deepseek-v3, maverick), whose moments the reference's loop keeps in
    float32 too; a cut of one fits one card only with bf16 moments.
    ``crash_at_step`` raises SimulatedCrash AFTER that step's update but
    BEFORE its checkpoint — the worst case.  ``clock``: as
    `make_train_step`'s.  ``mesh``: train this rank's shards on it
    (module docstring; by default this process alone); its collective
    counts (`Mesh.stats`) then cover the steps alone."""
    dev = device_lib.resolve(device)
    check_trainable(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if mesh is None:
        mesh = comm.Mesh((1,), ("data",), device=dev, alone=True)
    fsdp.check_rows(batch, num_microbatches, tuple(mesh.shape.values()))
    layout = model.layout_on(mesh, cfg)
    params = layout.attach(model.trainable(
        model.init_params(cfg, seed, dev, keep=layout.local)))
    opt = adamw.init(params, common.dtype_of(cfg.optimizer_state_dtype))
    start = 0
    resumed = None
    if checkpoint_dir and ckpt.latest_step(checkpoint_dir) is not None:
        opt, start = _restore(checkpoint_dir, params, opt, cfg, layout)
        resumed = start
        print_fn(f"[train] resumed from step {start}")

    lr_fn = adamw.cosine_schedule(lr, warmup, steps)
    step_fn = make_train_step(cfg, lr_fn, num_microbatches, clock=clock,
                              mesh=mesh)
    mesh.reset_stats()

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
                writer = _save(checkpoint_dir, step + 1, params, opt, cfg,
                               layout, blocking=not async_ckpt)
            if crash_at_step is not None and step == crash_at_step:
                raise SimulatedCrash(f"injected crash after step {step}")
    finally:
        prefetch.close()
        if writer is not None:
            writer.join()
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    return TrainResult(params=params, opt_state=opt, losses=losses,
                       resumed_from=resumed, steps_run=steps - start,
                       step_seconds=seconds, grad_norms=norms,
                       peak_gib=peak)


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
