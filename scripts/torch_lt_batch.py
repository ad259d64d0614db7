"""Host-clock time of whole LT batches on one GPU, and of the host side of
each level's kernel call, on the sampling launcher's graph.

    PYTHONPATH=src python scripts/torch_lt_batch.py [--src DIR]
        [--batches 16] [--rounds 3] [--out FILE]

Builds the launcher's graph (`powerlaw_cluster(65,536, 6.0, p = 0.25,
seed 7)`, deduped) and one LT ``kernel`` sampler per grid (the compacted
list, ``frontier="sparse"``, and the dense grid) over one tile layout,
samples one warm-up batch on each, then batches ``0 .. N-1`` on each grid
in turns for R rounds, synchronising around every batch.  Each level's
`kernels.ops.lt_select_expand` call is timed on the host clock too: its
checks, its slot-list lookup and its launch, not the kernel, which runs
asynchronously.  The level loop syncs twice a level (``any_set`` and the
list's length), so that host time adds to the batch.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (to
hold two versions against each other in one session on one card); the
script needs only what every version of the LT sampler has.  The card's
name and power limit head the output; one JSON line ends it (and goes to
``--out`` when given).  Needs a CUDA GPU and ``nvcc``; exits non-zero
without them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _quantiles(xs) -> dict:
    import numpy as np
    a = np.asarray(xs, dtype=float)
    return {"median": float(np.median(a)), "p10": float(np.quantile(a, .1)),
            "p90": float(np.quantile(a, .9)), "mean": float(a.mean()),
            "n": int(a.size)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    if not torch.cuda.is_available():
        print("torch_lt_batch: needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.graph import csr, generators
    from repro_torch.kernels import ops
    from repro_torch.sampling import SamplerSpec, make_sampler

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[lt batch] {card}; torch {torch.__version__}; repro_torch from "
          f"{os.path.dirname(ops.__file__)}")
    g = csr.dedupe(generators.powerlaw_cluster(65536, 6.0, prob=0.25, seed=7,
                                               device="cuda"))
    samplers = {}
    for frontier in ("sparse", "dense"):
        spec = SamplerSpec(diffusion="lt", backend="kernel", num_colors=64,
                           master_seed=0, frontier=frontier)
        first = next(iter(samplers.values()), None)
        samplers[frontier] = make_sampler(
            g, spec, g_rev=None if first is None else first.g_rev)

    host_s: list[float] = []
    inner = ops.lt_select_expand

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        host_s.append(time.perf_counter() - t0)
        return out

    ops.lt_select_expand = timed
    for s in samplers.values():            # builds, lists, first calls
        s.sample(0)
    torch.cuda.synchronize()
    res = {k: {"batch_ms": [], "levels": [], "call_us": []}
           for k in samplers}
    for _ in range(args.rounds):
        for frontier, s in samplers.items():
            for b in range(args.batches):
                host_s.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.sample(b)
                torch.cuda.synchronize()
                r = res[frontier]
                r["batch_ms"].append(1e3 * (time.perf_counter() - t0))
                r["levels"].append(s.last_levels)
                r["call_us"].extend(1e6 * x for x in host_s)
    ops.lt_select_expand = inner
    out = {"label": args.label, "card": card, "batches": args.batches,
           "rounds": args.rounds}
    for frontier, r in res.items():
        per_level = [ms / lv for ms, lv in zip(r["batch_ms"], r["levels"])]
        out[frontier] = {"batch_ms": _quantiles(r["batch_ms"]),
                         "ms_per_level": _quantiles(per_level),
                         "levels": _quantiles(r["levels"]),
                         "call_host_us": _quantiles(r["call_us"])}
        q = out[frontier]
        print(f"[lt batch] {frontier}: batch median "
              f"{q['batch_ms']['median']:.3f} ms (p10 "
              f"{q['batch_ms']['p10']:.3f}, p90 {q['batch_ms']['p90']:.3f}; "
              f"{q['batch_ms']['n']} batches), "
              f"{q['ms_per_level']['median']:.4f} ms a level over "
              f"{q['levels']['median']:.0f} levels; lt_select_expand call "
              f"on the host median {q['call_host_us']['median']:.1f} us "
              f"(p90 {q['call_host_us']['p90']:.1f})")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
