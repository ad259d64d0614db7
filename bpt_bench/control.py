"""The control of ``correct``: the plain reference in the program's place,
computed one precision below what the configuration states, read by the
same compares a run makes.  Not part of a benchmark run.

    python3 bpt_bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: batches at indices drawn from the seed are sampled by the
plain sampler with float32 probabilities (the configuration's) and with
bfloat16 ones (the control), and ``mask_bits_off`` counts the bits that
differ.  A ``queries`` cell also builds the program's pool and reads
``answer_gap`` of sampled σ and marginal answers computed from it in
float32 against float64.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def _answers_f32_gap(pool, config, rng, n_queries: int) -> float:
    import numpy as np
    import torch

    from bpt_bench.reference import answers
    C = int(config["num_colors"])
    nv, theta = pool.shape[1], pool.shape[0] * C
    gap = 0.0
    for _ in range(n_queries):
        s = rng.integers(0, nv, int(rng.integers(1, 9))).tolist()
        c = answers.sigma_count(pool, s, C)
        low = np.float32(c) * np.float32(nv) / np.float32(theta)
        gap = max(gap, abs(float(low) - answers.estimate(c, nv, theta)))
        m = answers.marginal_counts(pool, s, C)
        want = answers.estimate(m, nv, theta)
        low = (m.to(torch.float32) * nv / theta).cpu().numpy()
        gap = max(gap, float(np.max(np.abs(low.astype(np.float64) - want))))
    return gap


def main(argv=None) -> int:
    import numpy as np
    import torch

    from bpt_bench import check, spec
    from bpt_bench.reference import graphgen, ic
    from bpt_bench.reference import rng as ref_rng

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--queries", type=int, default=8)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(
        cell["traffic"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 17])
        edges = graphgen.deployment_graph(config, seed)
        span = int(traffic["pool_batches"]) * 64
        idx = sorted(int(i) for i in r.choice(span, args.batches,
                                                replace=False))
        rev = ic.reverse(edges, dev)
        words = [ic.pack(ic.sample(rev, seed, i, int(config["num_colors"]),
                                   max_levels=int(config["max_levels"]),
                                   prob_dtype=torch.bfloat16))
                 for i in idx]
        found = check.batches_against_reference(
            [(i, ref_rng.roots(seed, i, edges.num_vertices,
                               int(config["num_colors"])), w)
             for i, w in zip(idx, words)],
            edges, config, seed, int(config["max_levels"]), dev)
        out = {"workload": args.workload, "seed": seed, "batches": idx,
               "mask_bits_off": found["mask_bits_off"]}
        if traffic["loop"] == "queries":
            from bpt_bench import program
            store = program.store(edges, config, seed,
                                  int(traffic["pool_batches"]), dev)
            pool = store.visited_stack()
            del store
            out["answer_gap"] = _answers_f32_gap(pool, config, r,
                                                 args.queries)
            del pool
            torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
