"""Synthetic graph generators (PyTorch port of ``repro.graph.generators``).

Host numpy code copied from the reference so the same seed draws the same
edge list; only the finished CSR moves to ``device``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph import csr


def _power_law_degrees(rng: np.random.Generator, n: int, avg_deg: float,
                       exponent: float = 2.5, d_max: int | None = None):
    """Sample integer outdegrees ~ power law with the requested mean."""
    d_max = d_max or max(4, int(np.sqrt(n) * 4))
    raw = rng.pareto(exponent - 1.0, size=n) + 1.0
    deg = raw / raw.mean() * avg_deg
    return np.clip(deg.round().astype(np.int64), 0, d_max)


def powerlaw_cluster(n: int, avg_deg: float, *, mixing: float = 0.2,
                     n_communities: int | None = None, exponent: float = 2.5,
                     prob: float | tuple[float, float] = (0.0, 1.0),
                     seed: int = 0, device="cuda") -> csr.Graph:
    """LFR-like directed graph: power-law degrees, power-law community sizes,
    fraction ``mixing`` of edges crossing communities."""
    rng = np.random.default_rng(seed)
    deg = _power_law_degrees(rng, n, avg_deg, exponent)
    n_comm = n_communities or max(2, int(np.sqrt(n) / 2))
    comm_sizes = _power_law_degrees(rng, n_comm, n / n_comm, 2.0,
                                    d_max=max(4, n // 2)) + 1
    comm_of = np.repeat(np.arange(n_comm), comm_sizes)[:n]
    if len(comm_of) < n:
        comm_of = np.concatenate(
            [comm_of, rng.integers(0, n_comm, n - len(comm_of))])
    rng.shuffle(comm_of)
    # Bucket vertices per community for intra-community endpoint sampling.
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
    keep = src != dst                      # drop self-loops
    src, dst = src[keep], dst[keep]
    p = _edge_probs(rng, len(src), prob)
    return csr.from_edges(src, dst, p, n, device=device)


def erdos_renyi(n: int, avg_deg: float, *, prob=0.1, seed: int = 0,
                device="cuda") -> csr.Graph:
    """G(n, m) with m = n·avg_deg directed edges, self-loops dropped."""
    rng = np.random.default_rng(seed)
    e = int(n * avg_deg)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return csr.from_edges(src, dst, _edge_probs(rng, len(src), prob), n,
                          device=device)


def rmat(scale: int, avg_deg: float, *, a=0.57, b=0.19, c=0.19,
         prob=(0.0, 1.0), seed: int = 0, device="cuda") -> csr.Graph:
    """Graph500-style R-MAT: recursive quadrant sampling → heavy skew."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    e = int(n * avg_deg)
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for bit in range(scale):
        r = rng.random((e, 2))
        src_bit = r[:, 0] > (a + b)
        # quadrant probabilities conditioned on the row half
        thresh = np.where(src_bit, c / max(c + (1 - a - b - c), 1e-9),
                          a / max(a + b, 1e-9))
        dst_bit = r[:, 1] > thresh
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return csr.from_edges(src, dst, _edge_probs(rng, len(src), prob), n,
                          device=device)


def _edge_probs(rng: np.random.Generator, e: int, prob) -> np.ndarray:
    if isinstance(prob, tuple):
        return rng.uniform(prob[0], prob[1], e).astype(np.float32)
    return np.full(e, prob, np.float32)
