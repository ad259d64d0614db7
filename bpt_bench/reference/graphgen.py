"""The deployments' graphs, made from a seed on the host.

A frozen copy of the port's ``graph.generators.powerlaw_cluster`` (an
LFR-like directed graph: power-law out-degrees capped at 4·√n, power-law
community sizes, a share ``mixing`` of edges crossing communities, self
loops dropped) with a constant IC probability, then the parallel edges
merged as the launcher's ``csr.dedupe`` merges them: p = 1 − Π(1 − pᵢ),
each log1p taken in float32 and the sum in float64.  The edge list comes
back sorted by (source, destination), the order in which the port's
``csr.from_edges`` keeps it.  Both sides of the benchmark get these
arrays: the program as a ``csr.Graph``, the plain reference as they are.

Nothing here imports the program; the copy is frozen so that a change to
the program's generator cannot change what the benchmark measures.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Edges:
    """A deduped directed edge list, sorted by (src, dst)."""
    src: np.ndarray     # (E,) int32
    dst: np.ndarray     # (E,) int32
    prob: np.ndarray    # (E,) float32 IC probability
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def _power_law_degrees(rng: np.random.Generator, n: int, avg_deg: float,
                       exponent: float = 2.5, d_max: int | None = None):
    d_max = d_max or max(4, int(np.sqrt(n) * 4))
    raw = rng.pareto(exponent - 1.0, size=n) + 1.0
    deg = raw / raw.mean() * avg_deg
    return np.clip(deg.round().astype(np.int64), 0, d_max)


def raw_edges(n: int, avg_deg: float, *, mixing: float = 0.2,
              exponent: float = 2.5, prob: float = 0.1, seed: int = 0):
    """``(src, dst, prob)`` as the generator draws them (int64, int64,
    float32), before any sort or merge."""
    rng = np.random.default_rng(seed)
    deg = _power_law_degrees(rng, n, avg_deg, exponent)
    n_comm = max(2, int(np.sqrt(n) / 2))
    comm_sizes = _power_law_degrees(rng, n_comm, n / n_comm, 2.0,
                                    d_max=max(4, n // 2)) + 1
    comm_of = np.repeat(np.arange(n_comm), comm_sizes)[:n]
    if len(comm_of) < n:
        comm_of = np.concatenate(
            [comm_of, rng.integers(0, n_comm, n - len(comm_of))])
    rng.shuffle(comm_of)
    order = np.argsort(comm_of, kind="stable")
    sorted_comm = comm_of[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_comm))
    ends = np.searchsorted(sorted_comm, np.arange(n_comm), side="right")

    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    e = len(src)
    cross = rng.random(e) < mixing
    dst = np.empty(e, np.int64)
    dst[cross] = rng.integers(0, n, cross.sum())
    idx = np.flatnonzero(~cross)
    c = comm_of[src[idx]]
    lo, hi = starts[c], ends[c]
    width = np.maximum(hi - lo, 1)
    dst[idx] = order[lo + (rng.random(len(idx)) * width).astype(np.int64)]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return src, dst, np.full(len(src), prob, np.float32)


def merge_parallel(src: np.ndarray, dst: np.ndarray, prob: np.ndarray,
                   num_vertices: int) -> Edges:
    """One edge per (src, dst) pair with the union probability, sorted by
    (src, dst)."""
    key = src.astype(np.int64) * num_vertices + dst.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    log_keep = np.log1p(-np.clip(prob.astype(np.float32), np.float32(0.0),
                                 np.float32(1.0 - 1e-7)))
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv.reshape(-1), log_keep)
    return Edges(src=(uniq // num_vertices).astype(np.int32),
                 dst=(uniq % num_vertices).astype(np.int32),
                 prob=(1.0 - np.exp(acc)).astype(np.float32),
                 num_vertices=int(num_vertices))


def deployment_graph(config: dict, seed: int) -> Edges:
    """The configuration's graph for ``seed``: the clone its
    ``graph_seed`` draws (``vertices``, ``arcs_per_vertex``, ``mixing``,
    ``exponent``, ``ic_prob``), with its vertices renumbered by a
    permutation drawn from ``seed``.  Every seed thus gets the same graph
    up to its labels: the same degrees, communities and edge count, so the
    work does not change with the seed, in another order."""
    n = int(config["vertices"])
    src, dst, prob = raw_edges(n, float(config["arcs_per_vertex"]),
                               mixing=float(config["mixing"]),
                               exponent=float(config["exponent"]),
                               prob=float(config["ic_prob"]),
                               seed=int(config["graph_seed"]))
    perm = np.random.default_rng(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32, 5]).permutation(n)
    return merge_parallel(perm[src], perm[dst], prob, n)
