"""Device memory the 128×128 tile layouts need for the launcher's graph.

    PYTHONPATH=src python scripts/torch_tile_memory.py [n ...]
        [--degree 6.0] [--orders identity,cluster]

For each n (default 16,384 … 131,072) and each vertex order (default
``identity``; any heuristic of `graph.reorder`) builds
``powerlaw_cluster(n, degree, prob=0.25, seed=7)`` on the CPU, dedupes it,
reorders it with ``reorder.apply`` and reverses it as the serving launcher
and the quantised path do, and prints the edge count, the number of
non-empty tiles (`core.tiles.edge_slot_map`, host code only — no stacks
are allocated), the edges per tile, the bytes of the stacks a GPU would
hold — prob (f32) + edge id (i32) for IC, prob + the selection-CDF
prefixes cb (f32) for LT, whose layout has no edge-id stack, and the
uint8 threshold stack of the quantised layout (`core.tiles.quantized`) —
and the host seconds of the reordering.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import tiles
from repro_torch.graph import csr, generators, reorder


def main(sizes, degree: float, orders) -> None:
    t = tiles.TILE
    print("n, degree, order, edges, tiles, edges per tile, IC GiB, LT GiB, "
          "q8 GiB, reorder s")
    for n in sizes:
        g = csr.dedupe(generators.powerlaw_cluster(
            n, degree, prob=0.25, seed=7, device="cpu"))
        for order in orders:
            t0 = time.perf_counter()
            g_ord, _ = reorder.apply(g, order)
            reorder_s = time.perf_counter() - t0
            g_rev = csr.transpose(g_ord)
            _, nt = tiles.edge_slot_map(g_rev, t)
            slot_gib = nt * t * t / 2 ** 30
            print(f"{n}, {degree}, {order}, {g_rev.num_edges}, {nt}, "
                  f"{g_rev.num_edges / nt:.2f}, {8 * slot_gib:.2f}, "
                  f"{8 * slot_gib:.2f}, {slot_gib:.2f}, {reorder_s:.2f}",
                  flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", nargs="*", type=int,
                    default=[16384, 32768, 65536, 131072])
    ap.add_argument("--degree", type=float, default=6.0)
    ap.add_argument("--orders", default="identity",
                    help="comma-separated reorder heuristics")
    args = ap.parse_args()
    main(args.sizes, args.degree, args.orders.split(","))
