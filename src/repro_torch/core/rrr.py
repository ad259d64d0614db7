"""Random Reverse Reachable (RRR) set batches (PyTorch port of
``repro.core.rrr``).

Batch ``b`` is a pure function of ``(graph, master_seed, b)``: its counter
seed comes from ``batch_seeds`` and its roots from ``batch_starts`` — the
same derivation as the reference, so a port batch is bit-identical to the
reference batch of the same index.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import traversal
from repro_torch.graph import csr


@dataclasses.dataclass(frozen=True)
class RRRBatch:
    """One fused batch of ``num_colors`` RRR sets.

    ``*_edge_visits`` are -1 on paths that do not instrument them (tiled,
    kernel, LT); only the dense IC sweeps (CSR and sparse) track stats."""
    visited: torch.Tensor       # (V, W) int32 bit patterns; column c = set c
    roots: np.ndarray           # (num_colors,) int32 root vertex per colour
    batch_index: int
    fused_edge_visits: int
    unfused_edge_visits: int


def batch_seeds(master_seed: int, batch_indices) -> np.ndarray:
    """(B,) uint32 counter seeds — one value per batch index."""
    return np.asarray(
        [(master_seed * 0x9E3779B9 + int(b) * 0x85EBCA6B) & 0xFFFFFFFF
         for b in batch_indices], np.uint32)


def batch_seed(master_seed: int, batch_index: int) -> int:
    """Distinct, reproducible RNG stream per batch (idempotent re-issue)."""
    return int(batch_seeds(master_seed, [batch_index])[0])


def batch_starts(num_vertices: int, num_colors: int, master_seed: int,
                 batch_index: int, sort: bool = False) -> np.ndarray:
    """The (num_colors,) int32 root vertices of batch ``batch_index``: the
    reference's ``jax.random.key(master_seed*1_000_003 + b)`` + ``randint``,
    reproduced without jax (`core.threefry`)."""
    return traversal.random_starts(master_seed * 1_000_003 + batch_index,
                                   num_vertices, num_colors, sort=sort)


def sample_batch(g_rev: csr.Graph, num_colors: int, master_seed: int,
                 batch_index: int, *, sort_starts: bool = False,
                 max_levels: int = 64, model: str = "ic") -> RRRBatch:
    """One fused batch on the REVERSED graph by the CSR sweep — the
    primitive under `repro_torch.sampling`'s dense backend.  ``model="lt"``
    runs the LT live-edge traversal (``g_rev`` must carry LT-normalised
    in-weights, `core.lt.normalize_lt_weights`); LT batches carry the -1
    "not instrumented" edge-visit sentinel."""
    seed = batch_seed(master_seed, batch_index)
    roots = batch_starts(g_rev.num_vertices, num_colors, master_seed,
                         batch_index, sort=sort_starts)
    if model == "lt":
        from repro_torch.core import lt
        visited = lt.run_fused_lt(g_rev, roots, num_colors, seed,
                                  max_levels=max_levels)
        return RRRBatch(visited, roots, batch_index, -1, -1)
    res = traversal.run_fused(g_rev, roots, num_colors, seed,
                              max_levels=max_levels)
    return RRRBatch(res.visited, roots, batch_index,
                    int(res.stats.fused_edge_visits.sum()),
                    int(res.stats.unfused_edge_visits.sum()))


def sample_collection(g: csr.Graph, theta: int,
                      num_colors: int | None = None,
                      master_seed: int | None = None, *, spec=None,
                      mesh=None) -> list[RRRBatch]:
    """θ RRR sets as ⌈θ/num_colors⌉ fused batches on transpose(g), through
    the `repro_torch.sampling` facade (``sampling.resolve_spec``: explicit
    num_colors/master_seed that disagree with ``spec`` raise).  ``mesh``
    (a `distributed.comm.Mesh`) backs the mesh backends; every rank then
    calls this and gets every batch.  The reference's legacy
    ``sample_batch`` keywords are not carried over."""
    from repro_torch import sampling

    spec = sampling.resolve_spec(spec, num_colors=num_colors,
                                 master_seed=master_seed)
    sampler = sampling.make_sampler(g, spec, mesh)
    return sampler.sample_many(range(-(-theta // spec.num_colors)))


def stack_visited(batches: list[RRRBatch]) -> torch.Tensor:
    """(B, V, W) stacked visited masks for seed selection."""
    return torch.stack([b.visited for b in batches])
