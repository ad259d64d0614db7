"""Training launcher (the reference's ``launch/train.py``): ``--arch``
selects a config of the registry, ``--smoke`` its reduced form.

    python -m repro_torch.launch.train --arch llama3.2-3b --smoke --device cpu
    python -m repro_torch.launch.train --arch llama3.2-3b --shape train_4k \
        --seq-len 4096 --batch 8 --microbatches 8 --steps 4      # one GPU

    python -m repro_torch.launch.train --arch mamba2-1.3b --smoke --device cpu
    python -m repro_torch.launch.train --arch zamba2-2.7b --shape train_4k \
        --seq-len 4096 --batch 8 --microbatches 8 --steps 3      # one GPU

Weights are random, from a seeded generator on the device; batches come
from `data.pipeline.SyntheticLM`.  Every arch of the registry trains: the
dense archs, phi-3-vision, musicgen, the MoE archs (deepseek-v3 with MLA,
maverick), mamba2 and zamba2.  On the card float32 at nemotron's head dim
192 raises NotImplementedError (no backward kernel takes it,
`train.step.check_trainable`), as does a ``--mesh`` of more than one
device anywhere (sharded training is not ported: ROADMAP.md §1).  A full
MoE config does not fit one card; `train.loop.train` trains a cut one.
`main` returns the run's numbers: losses, grad norms, per-step seconds
(host clock, synchronised each step), tokens/s over the steps after the
first, peak device memory and the forward / backward / optimizer split.
"""
from __future__ import annotations

import argparse
import math
import statistics

import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.models.config import SHAPES
from repro_torch.train import loop


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
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mesh and math.prod(int(x) for x in args.mesh.split("x")) > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training (sharding_rules, FSDP/TP "
            "over distributed.comm.Mesh) is not ported; see ROADMAP.md §1")
    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    shp = SHAPES[args.shape]
    batch = args.batch or (8 if args.smoke else shp.global_batch)
    seq = args.seq_len or (64 if args.smoke else shp.seq_len)
    dev = device_lib.resolve(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    clock: dict = {}
    res = loop.train(cfg, batch=batch, seq_len=seq, steps=args.steps,
                     lr=args.lr, checkpoint_dir=args.checkpoint_dir,
                     ckpt_every=args.ckpt_every,
                     num_microbatches=args.microbatches, device=dev,
                     clock=clock)
    secs = res.step_seconds
    step_s = statistics.median(secs[1:] or secs)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    print(f"[launch.train] {cfg.name}: loss {res.losses[0]:.3f} → "
          f"{res.losses[-1]:.3f} over {res.steps_run} steps of {batch} × "
          f"{seq} tokens, {step_s:.3f}s a step ({batch * seq / step_s:.0f} "
          f"tokens/s) on {dev}")
    return dict(cfg=cfg, batch=batch, seq_len=seq, losses=res.losses,
                grad_norms=res.grad_norms, step_seconds=secs, step_s=step_s,
                tokens_per_s=batch * seq / step_s, peak_gib=peak,
                clock=clock, steps_run=res.steps_run,
                resumed_from=res.resumed_from)


if __name__ == "__main__":
    main()
