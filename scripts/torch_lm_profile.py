"""Where the time of the port's LM serving path goes on one GPU.

    PYTHONPATH=src python scripts/torch_lm_profile.py [--batch 4]
        [--prompt-len 2048] [--steps 8] [--arch llama3.2-3b] [--layers N]

Builds ``--arch`` at full width (its own depth, or ``--layers`` of it:
deepseek-v3-671b 5 and llama4-maverick-400b-a17b 2 are the depths the
chip smoke serves; bf16, the launcher's seeded init) on the card, warms
one prefill and a few decode steps, then traces
one prefill and ``--steps`` decode steps with ``torch.profiler``.  For each
of the two it prints the host-clock time (device synchronised), the summed
device time of its kernels, their ratio (the device's busy share; the rest
is the device waiting on the host), and the kernels that take the most
device time.  Needs a CUDA GPU; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.models import decode, model
from repro_torch.serve import engine


def _device_ms(prof) -> tuple[float, int, list[tuple[str, float, int]]]:
    """Summed device time of the trace's kernels and copies, their number,
    and the top ten by name (ms, calls)."""
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:10]


def _traced(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return wall, *_device_ms(prof)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--arch", default="llama3.2-3b", choices=registry.ARCHS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: as is)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lm_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = dataclasses.replace(registry.get(args.arch), num_patches=0)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    b, lp, n = args.batch, args.prompt_len, args.steps
    print(f"[profile] {torch.cuda.get_device_name(0)}; {cfg.name}, "
          f"{cfg.num_layers} layers, {cfg.dtype}; batch {b}, prompt {lp}, "
          f"{n} decode steps")
    with torch.inference_mode():
        params = model.init_params(cfg, seed=0, device=dev)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, lp))).to(dev)
        max_len = lp + n + 2
        state = {}

        def run_prefill():
            state["logits"], state["caches"], _ = engine.prefill(
                params, cfg, {"tokens": prompt}, max_len)

        def run_decode(start):
            logits, caches = state["logits"], state["caches"]
            for i in range(n):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                logits, caches = decode.decode_step(params, cfg, caches, tok,
                                                    start + i)

        run_prefill()                      # warm: cuBLAS plans, allocator
        run_decode(lp)
        for name, fn in (("prefill", run_prefill),
                         ("decode", lambda: run_decode(lp))):
            wall, device, count, top = _traced(fn)
            if not top:
                raise RuntimeError("the trace holds no device events: "
                                   "time with CUDA events instead")
            per = (f" ({wall / n:.3f} ms and {count / n:.0f} device "
                   f"events per step)" if name == "decode" else "")
            print(f"[profile] {name}: host clock {wall:.3f} ms{per}, "
                  f"{count} device events (kernels and copies), "
                  f"{device:.3f} ms of device time, busy share "
                  f"{device / wall:.1%}")
            for key, ms, calls in top:
                print(f"[profile]   {name} {ms:9.3f} ms  {calls:6d}×  "
                      f"{key[:90]}")
    print(f"[profile] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
