"""Where the time of the port's LM serving path goes on one GPU.

    PYTHONPATH=src python scripts/torch_lm_profile.py [--batch 4]
        [--prompt-len 2048] [--steps 8] [--arch llama3.2-3b ...] [--layers N]
    PYTHONPATH=src python scripts/torch_lm_profile.py --arch mamba2-1.3b zamba2-2.7b

Builds each ``--arch`` in turn at full width (its own depth, or
``--layers`` of it: deepseek-v3-671b 5 and llama4-maverick-400b-a17b 2
are the depths the chip smoke serves; mamba2-1.3b, zamba2-2.7b and
phi-3-vision-4.2b it serves whole; bf16, the launcher's seeded init,
patches off as the launcher has them) on the card, warms one
prefill and a few decode steps, then traces one prefill and ``--steps``
decode steps with ``torch.profiler``.  For each of the two it prints the
host-clock time (device synchronised), the summed device time of its
kernels, their ratio (the device's busy share; the rest is the device
waiting on the host), the device time of each kernel class (`CLASSES`:
the flash kernels, float32 GEMMs, bf16 GEMMs, the rest) and the kernels
that take the most device time.  Needs a CUDA GPU;
exits non-zero without one.
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


# Kernel classes by name, first match wins: the port's flash kernels,
# float32 GEMMs (CUDA-core FFMA; TF32 is off), the other GEMMs (bf16 on
# the tensor cores), and everything else (elementwise, reductions,
# copies).
CLASSES = (("flash", ("flash",)), ("f32 GEMM", ("f32f32",)),
           ("bf16 GEMM", ("gemm", "nvjet", "xmma")), ("other", ("",)))


def _class_of(name: str) -> str:
    return next(c for c, keys in CLASSES if any(k in name for k in keys))


def _device_ms(prof) -> tuple[float, int, dict,
                               list[tuple[str, float, int]]]:
    """Summed device time of the trace's kernels and copies, their number,
    the device ms of each of `CLASSES`, and the top ten by name (ms,
    calls)."""
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    by_class = dict.fromkeys((c for c, _ in CLASSES), 0.0)
    for key, ms, _ in rows:
        by_class[_class_of(key)] += ms
    return sum(r[1] for r in rows), sum(r[2] for r in rows), by_class, \
        rows[:10]


def _traced(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return wall, *_device_ms(prof)


def profile_arch(arch: str, args, dev) -> None:
    """Trace ``arch``'s prefill and decode steps (module docstring)."""
    cfg = dataclasses.replace(registry.get(arch), num_patches=0)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    b, lp, n = args.batch, args.prompt_len, args.steps
    print(f"[profile] {torch.cuda.get_device_name(0)}; {cfg.name}, "
          f"{cfg.num_layers} layers, {cfg.dtype}; batch {b}, prompt {lp}, "
          f"{n} decode steps")
    torch.cuda.reset_peak_memory_stats()
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
            wall, device, count, by_class, top = _traced(fn)
            if not top:
                raise RuntimeError("the trace holds no device events: "
                                   "time with CUDA events instead")
            per = (f" ({wall / n:.3f} ms and {count / n:.0f} device "
                   f"events per step)" if name == "decode" else "")
            print(f"[profile] {cfg.name} {name}: host clock {wall:.3f} ms"
                  f"{per}, {count} device events (kernels and copies), "
                  f"{device:.3f} ms of device time, busy share "
                  f"{device / wall:.1%}; by class "
                  + ", ".join(f"{c} {ms:.3f} ms ({ms / device:.1%})"
                              for c, ms in by_class.items()))
            for key, ms, calls in top:
                print(f"[profile]   {name} {ms:9.3f} ms  {calls:6d}×  "
                      f"{key[:90]}")
        del params, state
    print(f"[profile] {cfg.name} peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--arch", nargs="+", default=["llama3.2-3b"],
                    choices=registry.ARCHS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: as is)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lm_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for arch in args.arch:
        profile_arch(arch, args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
