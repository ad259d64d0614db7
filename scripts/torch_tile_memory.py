"""Device memory the 128×128 tile layout needs for the launcher's graph.

    PYTHONPATH=src python scripts/torch_tile_memory.py [n ...]

For each n (default 16,384 … 131,072) builds ``powerlaw_cluster(n, 6.0,
prob=0.25, seed=7)`` on the CPU, dedupes and reverses it as the serving
launcher does, and prints the edge count, the number of non-empty tiles
(`core.tiles.edge_slot_map`, host code only — no stacks are allocated),
the bytes of the stacks a GPU would hold — prob (f32) + edge id (i32) for
IC, prob + the selection-CDF prefixes cb (f32) for LT, whose layout has no
edge-id stack — and the share of tile slots that hold an edge.
"""
from __future__ import annotations

import sys

from repro_torch.core import tiles
from repro_torch.graph import csr, generators


def main(sizes) -> None:
    t = tiles.TILE
    print("n, edges, tiles, IC GiB, LT GiB, edges per tile, slot occupancy")
    for n in sizes:
        g_rev = csr.transpose(csr.dedupe(generators.powerlaw_cluster(
            n, 6.0, prob=0.25, seed=7, device="cpu")))
        _, nt = tiles.edge_slot_map(g_rev, t)
        stack_gib = nt * t * t * 4 / 2 ** 30
        print(f"{n}, {g_rev.num_edges}, {nt}, {2 * stack_gib:.1f}, "
              f"{2 * stack_gib:.1f}, "
              f"{g_rev.num_edges / nt:.2f}, "
              f"{g_rev.num_edges / (nt * t * t):.6f}")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [16384, 32768, 65536, 131072])
