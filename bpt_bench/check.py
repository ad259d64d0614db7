"""What the loops share to decide ``correct``: a seeded sample of the
window's outputs, and the compare of the program's masks with the plain
sampler's.

Every number compared has a limit, and a run is correct when each number
is at most its limit.  The masks and roots are integers the RNG contract
fixes bit for bit, so their limits are 0.
"""
from __future__ import annotations

import numpy as np
import torch

from bpt_bench.reference import ic, rng


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream, drawn from
    ``seed`` (the same stream and seed keep the same items)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                           int(seed) >> 32, 7])

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def batches_against_reference(batches, edges, config: dict, seed: int,
                              max_levels: int, device,
                              prob_dtype=torch.float32) -> dict:
    """Compare each ``(batch_index, roots, visited words)`` with the plain
    sampler's batch of that index: the mask bits and the roots that
    differ, summed."""
    rev = ic.reverse(edges, device)
    C = int(config["num_colors"])
    bits = roots_off = 0
    for index, roots, words in batches:
        want = ic.sample(rev, seed, index, C, max_levels=max_levels,
                         prob_dtype=prob_dtype)
        got = ic.unpack(words.to(device), C)
        bits += int((want != got).sum())
        ref_roots = rng.roots(seed, index, edges.num_vertices, C)
        roots_off += int((np.asarray(roots, np.int64) != ref_roots).sum())
        del want, got
    return {"mask_bits_off": bits, "roots_off": roots_off}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
