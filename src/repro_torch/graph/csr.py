"""CSR graph structure (PyTorch port of ``repro.graph.csr``).

The host work — stable sorts, dedupe, padding — is the reference's numpy
code line for line: CSR edge ids are the RNG counters, so any change in
edge order would change every sampled bit.  Tensors move to the device at
the end.  Padding edges point at row 0 with probability 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph in flat edge-list + CSR form.

    Attributes:
      indptr:  (V+1,) int32 CSR row pointers (sorted by src).
      src:     (E_pad,) int32 edge sources (CSR order; padding → row 0).
      dst:     (E_pad,) int32 edge destinations.
      prob:    (E_pad,) float32 IC activation probability per edge.
      num_vertices / num_edges: python ints (E = real edge count).
      cache:   derived structures keyed by name (the transpose, tile
               layouts) — built once per graph object, which is never
               mutated, so every sampler over it shares them.
    """
    indptr: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    prob: torch.Tensor
    num_vertices: int
    num_edges: int
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def padded_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def edges_numpy(self):
        """Host copies of the real (unpadded) ``src, dst, prob``."""
        e = self.num_edges
        return (self.src[:e].cpu().numpy(), self.dst[:e].cpu().numpy(),
                self.prob[:e].cpu().numpy())


def from_edges(src: np.ndarray, dst: np.ndarray, prob: np.ndarray,
               num_vertices: int, pad_to: Optional[int] = None,
               dedupe: bool = False, *, device="cuda") -> Graph:
    """Build a CSR-ordered Graph from an edge list (numpy, host-side).

    ``dedupe=True`` merges parallel (src, dst) edges with the IC-preserving
    union probability — required by the dense-tile layout (core/tiles.py).
    """
    dev = device_lib.resolve(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    prob = np.asarray(prob, np.float32)
    if dedupe:
        from repro_torch.core.tiles import dedupe_edges
        src, dst, prob = dedupe_edges(src, dst, prob)
    order = np.argsort(src, kind="stable")
    src, dst, prob = src[order], dst[order], prob[order]
    counts = np.bincount(src, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    e = len(src)
    pad_to = pad_to or e
    if pad_to < e:
        raise ValueError(f"pad_to={pad_to} < num_edges={e}")
    pad = pad_to - e
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        prob = np.concatenate([prob, np.zeros(pad, np.float32)])
    return Graph(
        indptr=torch.from_numpy(indptr.astype(np.int32)).to(dev),
        src=torch.from_numpy(src).to(dev),
        dst=torch.from_numpy(dst).to(dev),
        prob=torch.from_numpy(prob).to(dev),
        num_vertices=int(num_vertices),
        num_edges=int(e),
    )


def dedupe(g: Graph) -> Graph:
    """``g`` rebuilt with parallel (src, dst) edges union-merged — the
    dedupe-clean graph every backend samples, so all of them share one edge
    list and one set of CSR edge ids."""
    return from_edges(*g.edges_numpy(), g.num_vertices, dedupe=True,
                      device=g.device)


def transpose(g: Graph) -> Graph:
    """Reverse every edge — RRR sets run the diffusion backwards (Def. 2).
    Built once per graph object and cached (``g.cache``)."""
    rev = g.cache.get("transpose")
    if rev is None:
        src, dst, prob = g.edges_numpy()
        rev = from_edges(dst, src, prob, g.num_vertices,
                         pad_to=g.padded_edges, device=g.device)
        g.cache["transpose"] = rev
    return rev


def relabel(g: Graph, perm: np.ndarray) -> Graph:
    """Apply a vertex permutation: new_id = perm[old_id] (reordering §5).
    The padded length is kept, as in the reference."""
    perm = np.asarray(perm, np.int32)
    src, dst, prob = g.edges_numpy()
    return from_edges(perm[src], perm[dst], prob, g.num_vertices,
                      pad_to=g.padded_edges, device=g.device)


def uniform_probs(rng: np.random.Generator, num_edges: int,
                  low: float = 0.0, high: float = 1.0) -> np.ndarray:
    """Paper §6: edge weights drawn uniformly, generated once and reused."""
    return rng.uniform(low, high, size=num_edges).astype(np.float32)
