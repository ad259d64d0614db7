"""Training launcher (the reference's ``launch/train.py``): ``--arch``
selects a config of the registry, ``--smoke`` its reduced form.

    python -m repro_torch.launch.train --arch llama3.2-3b --smoke --device cpu
    python -m repro_torch.launch.train --arch llama3.2-3b --shape train_4k \
        --seq-len 4096 --batch 8 --microbatches 8 --steps 4      # one GPU

    python -m repro_torch.launch.train --arch mamba2-1.3b --smoke --device cpu
    python -m repro_torch.launch.train --arch zamba2-2.7b --shape train_4k \
        --seq-len 4096 --batch 8 --microbatches 8 --steps 3      # one GPU

    python -m repro_torch.launch.train --arch llama3.2-3b --smoke \
        --device cpu --mesh 2x2 --backend gloo --steps 3   # 4 CPU ranks
    python -m repro_torch.launch.train --arch llama3.2-3b --smoke \
        --mesh 2x2 --backend gloo         # 4 ranks sharing one GPU
    python -m repro_torch.launch.train --arch llama3.2-3b --smoke \
        --mesh 2x2                        # 4 GPUs, NCCL, one a rank

Weights are random, from a seeded generator on the device; batches come
from `data.pipeline.SyntheticLM`.  Every arch of the registry trains: the
dense archs, phi-3-vision, musicgen, the MoE archs (deepseek-v3 with MLA,
maverick), mamba2 and zamba2, on the card in either dtype
(`train.step.check_trainable` refuses no arch of the registry; it raises
NotImplementedError only for a head dim that no backward kernel takes).
A full MoE config does not fit one card; `train.loop.train` trains a cut
one.

``--mesh DxM`` (``(data, model)``; three dims ``(pod, data, model)``)
trains sharded (ZeRO-3 over the whole mesh, `distributed.fsdp`): one
process a mesh position, started by `launch.accel.spawn` in a process
group of ``--backend`` (``nccl`` by default, one card a rank; ranks that
share a card must ask for ``gloo``, since NCCL refuses two ranks on one
device; nothing falls back from one to the other).  Each microbatch's
rows must split evenly over the ranks: a batch that does not raises
ValueError before any rank starts.  A ``--mesh`` of one rank runs every
collective over one-rank groups.  Called in a process whose default
group is already up (torchrun's way: every rank of a started world calls
`main` with the same arguments, as a `launch.accel` rank program does),
``--mesh`` runs this process's rank in that group instead of starting
ranks; the group must hold the mesh's ranks over ``--backend``.

`main` returns the run's numbers: losses, grad norms, per-step seconds
(host clock, synchronised each step), tokens/s over the steps after the
first, peak device memory and the forward / backward / optimizer split;
on a mesh rank 0's, with every rank's peak (``rank_peak_gib``), launches
and collective counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import statistics

import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.models.config import SHAPES
from repro_torch.train import loop

# The kernels a training rank launches, built in the parent before the
# ranks start (so that they never build into one directory at once).
TRAIN_KERNELS = ("flash_attention", "flash_prefill_wgmma",
                 "flash_attention_bwd", "flash_bwd_wgmma",
                 "flash_prefill_tf32x3", "flash_bwd_tf32x3")
# Each rank's caching allocator grows its segments in place: ranks that
# share a card otherwise each keep GiBs reserved but unused (fragments of
# the vocabulary-sized logits and gradients), which four ranks cannot
# spare.
RANK_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def parse_mesh(spec: str | None) -> tuple[tuple, tuple]:
    """(shape, axes) of a ``--mesh`` spec, the reference's: None is one
    ``data`` axis over the process group (1 without one); ``DxM`` is
    ``(data, model)``; three dims ``(pod, data, model)``."""
    if spec is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        return (n,), ("data",)
    dims = tuple(int(x) for x in spec.split("x"))
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(dims)]
    return dims, axes


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None, help="e.g. 16x16 or 2x16x16")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="the mesh's process group (gloo when ranks share "
                         "a card)")
    ap.add_argument("--timeout-s", type=float, default=1800.0,
                    help="bound on each collective and on the ranks' run")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the config's depth (the card's cut runs)")
    ap.add_argument("--num-experts", type=int, default=None,
                    help="cut a MoE config's experts")
    return ap.parse_args(argv)


def _config(args):
    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    cuts = {k: v for k, v in (("num_layers", args.num_layers),
                              ("num_experts", args.num_experts))
            if v is not None}
    if cuts:
        cfg = dataclasses.replace(cfg, **cuts)
    shp = SHAPES[args.shape]
    batch = args.batch or (8 if args.smoke else shp.global_batch)
    seq = args.seq_len or (64 if args.smoke else shp.seq_len)
    return cfg, batch, seq


def _run(args, dev, mesh=None) -> dict:
    """One process's training run and its numbers (`main`'s)."""
    from repro_torch.kernels import ops

    cfg, batch, seq = _config(args)
    clock: dict = {}
    ops.reset_launches()
    res = loop.train(cfg, batch=batch, seq_len=seq, steps=args.steps,
                     lr=args.lr, checkpoint_dir=args.checkpoint_dir,
                     ckpt_every=args.ckpt_every,
                     num_microbatches=args.microbatches, device=dev,
                     clock=clock, mesh=mesh,
                     print_fn=print if mesh is None or mesh.rank == 0
                     else (lambda *a, **k: None))
    secs = res.step_seconds
    step_s = statistics.median(secs[1:] or secs)
    out = dict(cfg=cfg, batch=batch, seq_len=seq,
               microbatches=args.microbatches, losses=res.losses,
               grad_norms=res.grad_norms, step_seconds=secs, step_s=step_s,
               tokens_per_s=batch * seq / step_s, peak_gib=res.peak_gib,
               clock=clock, steps_run=res.steps_run,
               resumed_from=res.resumed_from, launches=dict(ops.LAUNCHES))
    if mesh is not None:
        out.update(rank=mesh.rank, backend=mesh.backend,
                   mesh_shape=dict(mesh.shape),
                   mesh_stats={a: dict(v) for a, v in mesh.stats.items()},
                   staged_bytes=mesh.staged_bytes)
    return out


def _rank_main(rank: int, dev, args) -> dict:
    """A mesh rank of `main` (run by `launch.accel.spawn`)."""
    from repro_torch.launch.mesh import make_mesh

    shape, axes = parse_mesh(args.mesh)
    return _run(args, dev, make_mesh(shape, axes, device=dev,
                                     timeout_s=args.timeout_s))


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, batch, seq = _config(args)
    dev = device_lib.resolve(args.device)
    if args.mesh is None:
        out = _run(args, dev)
        where = str(dev)
    else:
        from repro_torch.distributed import fsdp
        from repro_torch.launch import accel

        shape, _ = parse_mesh(args.mesh)
        fsdp.check_rows(batch, args.microbatches, shape)
        if dist.is_initialized():
            size = math.prod(shape)
            if dist.get_world_size() != size \
                    or dist.get_backend() != args.backend:
                raise ValueError(
                    f"--mesh {args.mesh} over {args.backend} in a started "
                    f"group of {dist.get_world_size()} "
                    f"{dist.get_backend()} ranks")
            rank = dist.get_rank()
            mine = _rank_main(rank, accel.rank_device(args.device, rank),
                              args)
            ranks = [None] * size
            dist.all_gather_object(ranks, {k: mine[k] for k in (
                "peak_gib", "launches", "losses")})
            ranks[rank] = mine
        else:
            ranks = accel.spawn(_rank_main, math.prod(shape),
                                args=(args,), backend=args.backend,
                                device=args.device, timeout_s=args.timeout_s,
                                kernels=TRAIN_KERNELS, env=RANK_ENV)
            rank = 0
        out = dict(ranks[rank],
                   rank_peak_gib=[r["peak_gib"] for r in ranks],
                   rank_launches=[r["launches"] for r in ranks],
                   rank_losses=[r["losses"] for r in ranks])
        if rank != 0:
            return out
        where = (f"a {args.mesh} mesh of {args.backend} ranks on "
                 f"{args.device}")
    print(f"[launch.train] {cfg.name}: loss {out['losses'][0]:.3f} → "
          f"{out['losses'][-1]:.3f} over {out['steps_run']} steps of "
          f"{batch} × {seq} tokens, {out['step_s']:.3f}s a step "
          f"({out['tokens_per_s']:.0f} tokens/s) on {where}")
    return out


if __name__ == "__main__":
    main()
