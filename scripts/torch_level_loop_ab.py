"""The level loop's host cost with tracing off and under a profile: another
checkout's ``core/tiled_traversal.py`` (loaded under another name) against
this tree's, in one process, batch by batch in turns.

    PYTHONPATH=src python scripts/torch_level_loop_ab.py OTHER_SRC \
        [--batches 300] [--rounds 5] [--n 16384]

``OTHER_SRC`` is the other checkout's ``src`` directory.  On a
``powerlaw_cluster`` graph of ``--n`` vertices (avg degree 14, deduped),
IC with the ``kernel`` backend, 256 colours and 64 levels at most, each
round runs every one of ``--batches`` batches with both loops, one right
after the other (which goes first alternates batch by batch and round by
round), the device synchronised around each; a run's figure is µs a
level.  Off, then with each round under a CPU-only profile.  Prints, for
each, both loops' medians and quartile spreads (Q3 − Q1 over the median,
``statistics.quantiles``), and the paired differences (this − other) of
one batch's two runs: their median, quartiles, and the share this tree
wins.  On the card a small graph keeps each level host-bound, the worst
case for the loop's own cost.
"""
from __future__ import annotations

import argparse
import importlib.util
import statistics as st
import subprocess
import time

import torch

from repro_torch import tracing
from repro_torch.core import tiled_traversal
from repro_torch.graph import csr, generators
from repro_torch.sampling import SamplerSpec, make_sampler


def _load(path: str):
    spec = importlib.util.spec_from_file_location("other_tiled_traversal",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quartiles(v: list[float]) -> str:
    q1, q2, q3 = st.quantiles(v, n=4)
    return (f"median {st.median(v):.3f}, quartiles {q1:.3f} {q3:.3f}, "
            f"spread {100 * (q3 - q1) / abs(q2):.2f}%")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_src")
    ap.add_argument("--batches", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--n", type=int, default=16384)
    a = ap.parse_args()
    other = _load(f"{a.other_src}/repro_torch/core/tiled_traversal.py")
    cuda = torch.cuda.is_available()
    dev = "cuda" if cuda else "cpu"
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    g = csr.dedupe(generators.powerlaw_cluster(
        n=a.n, avg_deg=14.0, prob=0.1, seed=3, device=dev))
    s = make_sampler(g, SamplerSpec(backend="kernel", num_colors=256,
                                    master_seed=5, max_iters=64))
    args = [(s.batch_starts(b), s.batch_seed(b)) for b in range(a.batches)]

    def one(mod, starts, seed) -> float:
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        _, lv, _ = mod.run_fused_tiled(s.tg_rev, starts, 256, seed,
                                       max_levels=64, work={})
        if cuda:
            torch.cuda.synchronize()
        return (time.perf_counter() - t) / lv * 1e6

    def rounds(profiled: bool) -> dict:
        res = {"other": [], "this": []}
        for r in range(a.rounds):
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) \
                if profiled else None
            if prof is not None:
                prof.__enter__()
            for b, (starts, seed) in enumerate(args):
                pair = (("other", other), ("this", tiled_traversal))
                for name, mod in (pair if (r + b) % 2 == 0 else pair[::-1]):
                    res[name].append(one(mod, starts, seed))
            if prof is not None:
                prof.__exit__(None, None, None)
                tracing.reset()
        return res

    rounds(False)                                       # warm
    print(f"{dev}: {a.batches} batches a round, {a.rounds} rounds")
    for tag, profiled in (("off", False), ("profiled", True)):
        res = rounds(profiled)
        for name, v in res.items():
            print(f"{tag} {name}: us a level {_quartiles(v)}")
        d = [t - o for o, t in zip(res["other"], res["this"])]
        q1, q2, q3 = st.quantiles(d, n=4)
        wins = sum(x < 0 for x in d) / len(d)
        mo = st.median(res["other"])
        print(f"{tag} this - other, paired: median {q2:+.3f} us a level "
              f"({100 * q2 / mo:+.2f}% of other's median), quartiles "
              f"{q1:+.3f} {q3:+.3f}; this faster in {100 * wins:.1f}% of "
              f"{len(d)} pairs")


if __name__ == "__main__":
    main()
