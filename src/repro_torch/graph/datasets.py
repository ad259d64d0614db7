"""Paper Table-1 graphs: SNAP loaders and size-faithful synthetic clones
(PyTorch port of ``repro.graph.datasets``).

A SNAP edge list (plain ``src dst`` rows, ``#`` comments, as
snap.stanford.edu distributes them) loads when it is already on disk
(``load_snap``); nothing is downloaded.  Otherwise ``table1_clone``
generates a power-law-clustered stand-in with the table's vertex count and
average degree, ``scale`` shrinking it proportionally.  The host numpy
code is the reference's, so the same file or seed gives the same edge
arrays; only the finished CSR moves to ``device``.
"""
from __future__ import annotations

import gzip
import os

import numpy as np

from repro_torch.graph import csr, generators

# name → (nodes, edges, avg_degree)  — paper Table 1
TABLE1 = {
    "web-BerkStan": (685_230, 7_600_595, 22.18),
    "web-Google": (875_713, 5_105_039, 11.66),
    "soc-pokec-relationships": (1_632_803, 30_622_564, 37.51),
    "wiki-topcats": (1_791_489, 28_511_807, 31.83),
    "com-Orkut": (3_072_441, 117_185_083, 76.28),
    "soc-LiveJournal1": (4_847_571, 68_993_773, 28.47),
}


def load_snap(path: str, num_vertices: int | None = None,
              prob=(0.0, 1.0), seed: int = 0, *,
              device="cuda") -> csr.Graph:
    """Load a SNAP edge list (.txt or .txt.gz, '#' comments); edge
    probabilities are drawn from ``default_rng(seed)``."""
    opener = gzip.open if path.endswith(".gz") else open
    src, dst = [], []
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            a, b = line.split()[:2]
            src.append(int(a))
            dst.append(int(b))
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n = num_vertices or int(max(src.max(), dst.max()) + 1)
    rng = np.random.default_rng(seed)
    p = generators._edge_probs(rng, len(src), prob)
    return csr.from_edges(src, dst, p, n, device=device)


def table1_clone(name: str, scale: float = 1.0, prob=(0.0, 1.0),
                 seed: int = 0, snap_dir: str | None = None, *,
                 device="cuda") -> csr.Graph:
    """Table-1 graph: the real edge list if ``snap_dir`` holds
    ``<name>.txt`` or ``<name>.txt.gz``, else a synthetic clone at
    ``scale`` of the published size.

    The clone's generator seed is ``seed + hash(name) % 4096``, as in the
    reference.  Python salts ``hash`` of a string per process, so a clone
    equals the reference's only inside one process or under a fixed
    ``PYTHONHASHSEED``; a run that must be repeatable calls
    ``generators.powerlaw_cluster`` with the table's sizes instead.
    """
    if name not in TABLE1:
        raise KeyError(f"unknown Table-1 graph {name!r}")
    if snap_dir:
        for ext in (".txt", ".txt.gz"):
            path = os.path.join(snap_dir, name + ext)
            if os.path.exists(path):
                return load_snap(path, prob=prob, seed=seed, device=device)
    v, e, deg = TABLE1[name]
    n = max(int(v * scale), 64)
    return generators.powerlaw_cluster(n, deg, prob=prob,
                                       seed=seed + hash(name) % 4096,
                                       device=device)
