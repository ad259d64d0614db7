"""Write the full-size golden values of the reference package for the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py

Builds the launcher's graph at the size the port's chip smoke serves
(``powerlaw_cluster(65536, 6.0, prob=0.25, seed=7)``, deduped, reversed),
samples batches 0-3 (master_seed 0, 64 colours) with the reference's dense
CSR backend, and records for each batch the sha256 of its visited mask as
little-endian uint32 plus its edge-visit counters, and the top-16 greedy
seeds over the 4-batch pool (``use_kernel=False``: the same function as the
Pallas coverage kernel, without interpret mode at 65,536 rows).  The same
under the LT diffusion (``SamplerSpec(diffusion="lt")``, which normalises
the reversed graph's in-weights) goes under ``"lt"``.  Output:
``tests/data/torch_port_golden.json``, which ``chip_smoke.py`` reads — the
one full-size check of the port on the GPU against the reference.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from repro.core import imm, tiles
from repro.graph import csr, generators
from repro.sampling import SamplerSpec, make_sampler

N, DEGREE, PROB, GRAPH_SEED = 65536, 6.0, 0.25, 7
COLORS, MASTER_SEED, BATCHES, K = 64, 0, 4, 16
OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests", "data",
                   "torch_port_golden.json")


def mask_sha256(visited) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(visited), "<u4").tobytes()).hexdigest()


def main() -> None:
    t0 = time.time()
    g = csr.dedupe(generators.powerlaw_cluster(N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    g_rev = csr.transpose(g)
    _, num_tiles = tiles.edge_slot_map(g_rev)
    pools = {}
    for diffusion in ("ic", "lt"):
        sampler = make_sampler(g, SamplerSpec(
            diffusion=diffusion, backend="dense", num_colors=COLORS,
            master_seed=MASTER_SEED), g_rev=g_rev)
        batches = sampler.sample_many(range(BATCHES))
        stack = np.stack([np.asarray(b.visited) for b in batches])
        pools[diffusion] = (batches, *imm.greedy_max_cover(
            stack, K, COLORS, use_kernel=False))
    batches, seeds, cov = pools["ic"]
    lt_batches, lt_seeds, lt_cov = pools["lt"]
    golden = {
        "graph": {"generator": "powerlaw_cluster", "n": N, "avg_deg": DEGREE,
                  "prob": PROB, "seed": GRAPH_SEED, "dedupe": True,
                  "num_edges": g.num_edges, "tile_size": tiles.TILE,
                  "num_tiles": int(num_tiles)},
        "num_colors": COLORS,
        "master_seed": MASTER_SEED,
        "batches": [
            {"batch_index": b.batch_index,
             "visited_sha256": mask_sha256(b.visited),
             "roots_sha256": hashlib.sha256(
                 np.ascontiguousarray(b.roots, "<i4").tobytes()).hexdigest(),
             "visited_bits": int(np.unpackbits(
                 np.asarray(b.visited).view(np.uint8)).sum()),
             "fused_edge_visits": b.fused_edge_visits,
             "unfused_edge_visits": b.unfused_edge_visits}
            for b in batches],
        "top_k": {"k": K, "batches": BATCHES, "seeds": seeds.tolist(),
                  "coverage": cov},
        "lt": {
            "batches": [
                {"batch_index": b.batch_index,
                 "visited_sha256": mask_sha256(b.visited),
                 "visited_bits": int(np.unpackbits(
                     np.asarray(b.visited).view(np.uint8)).sum())}
                for b in lt_batches],
            "top_k": {"k": K, "batches": BATCHES,
                      "seeds": lt_seeds.tolist(), "coverage": lt_cov},
        },
    }
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {os.path.normpath(OUT)} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
