"""The plain IC sampler: one batch of reverse-reachable sets, written from
the definition in plain PyTorch.

A batch of C colours starts colour c at its root (`rng.roots`) and runs a
level-synchronous BFS on the reversed graph: at level t every
(vertex u, colour c) pair of the frontier tries each edge u → v of the
reversed graph whose head v does not yet hold c, and crosses it when the
uniform of ``hash(seed, t, edge id, c)`` lies below the edge's
probability.  The visited set takes the frontier before each level; the
loop stops when the frontier is empty or after ``max_levels`` levels, and
the colours still in the frontier then join the visited set.  Edge ids
are positions in the reversed graph's CSR arrays, each row listing its
edges by ascending head (the order the program keeps for an edge list
sorted by (source, destination)).

Masks are bool ``(V, C)`` tensors, one column per colour.  The work is
walked as (edge, colour) pairs in chunks, so a batch of 256 colours over
millions of edges fits in a few GiB of the card.  Nothing here imports
the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bpt_bench.reference import rng
from bpt_bench.reference.graphgen import Edges

# (edge, colour) pairs walked at once: ~0.5 GiB per int64 temporary.
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class Reversed:
    """The reversed graph in CSR form on one device."""
    indptr: torch.Tensor    # (V + 1,) int64
    head: torch.Tensor      # (E,) int64, the head of edge id e
    prob: torch.Tensor      # (E,) float32
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.head.shape[0])


def reverse(edges: Edges, device) -> Reversed:
    """Edge (s → d) becomes (d → s); rows by d, each row by ascending s."""
    order = np.lexsort((edges.src, edges.dst))
    tail = edges.dst[order].astype(np.int64)
    counts = np.bincount(tail, minlength=edges.num_vertices)
    indptr = np.zeros(edges.num_vertices + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Reversed(
        indptr=torch.from_numpy(indptr).to(device),
        head=torch.from_numpy(edges.src[order].astype(np.int64)).to(device),
        prob=torch.from_numpy(np.ascontiguousarray(
            edges.prob[order])).to(device),
        num_vertices=edges.num_vertices)


def _pairs(g: Reversed, u: torch.Tensor, c: torch.Tensor):
    """Yield (edge id, colour) int64 tensors of every edge out of each
    frontier pair (u[i], c[i]), at most ~CHUNK pairs at a time."""
    deg = g.indptr[u + 1] - g.indptr[u]
    cum = torch.cumsum(deg, 0)
    total = int(cum[-1]) if cum.numel() else 0
    a = 0
    while a < u.numel() and total:
        base = int(cum[a - 1]) if a else 0
        b = int(torch.searchsorted(cum, base + CHUNK, right=True))
        b = max(b, a + 1)
        d = deg[a:b]
        n = int(cum[b - 1]) - base
        owner = torch.repeat_interleave(
            torch.arange(b - a, device=u.device), d, output_size=n)
        first = (cum[a:b] - d - base)[owner]
        e = g.indptr[u[a:b]][owner] + (torch.arange(n, device=u.device)
                                       - first)
        yield e, c[a:b][owner]
        a = b


def sample(g: Reversed, master_seed: int, batch_index: int, num_colors: int,
           max_levels: int = 64, prob_dtype=torch.float32,
           live_pairs: list | None = None) -> torch.Tensor:
    """The batch's visited mask, bool ``(V, C)``.

    ``prob_dtype`` below float32 (the control) rounds each probability to
    that type before the compare.  ``live_pairs``, when given, receives
    per level the number of (edge, colour) pairs whose tail held the
    colour in the frontier."""
    dev = g.head.device
    V, C = g.num_vertices, num_colors
    seed = rng.batch_seed(master_seed, batch_index)
    prob = g.prob.to(prob_dtype).to(torch.float32)
    roots = torch.from_numpy(
        rng.roots(master_seed, batch_index, V, C)).to(dev)
    frontier = torch.zeros((V, C), dtype=torch.bool, device=dev)
    frontier[roots, torch.arange(C, device=dev)] = True
    visited = torch.zeros_like(frontier)
    eid = torch.arange(g.num_edges, dtype=torch.int64, device=dev)
    level = 0
    while level < max_levels and bool(frontier.any()):
        visited |= frontier
        h_edge = rng.fold(rng.level_prefix(seed, level), eid)
        nxt = torch.zeros_like(frontier)
        u, c = frontier.nonzero(as_tuple=True)
        live = 0
        for e, col in _pairs(g, u, c):
            live += e.numel()
            cell = g.head[e] * C + col
            keep = ~visited.view(-1)[cell]
            e, col, cell = e[keep], col[keep], cell[keep]
            hit = rng.uniform(rng.fold(h_edge[e], col)) < prob[e]
            nxt.view(-1)[cell[hit]] = True
        if live_pairs is not None:
            live_pairs.append(live)
        frontier = nxt
        level += 1
    return visited | frontier


def unpack(words: torch.Tensor, num_colors: int) -> torch.Tensor:
    """int32 ``(V, W)`` colour words → bool ``(V, C)`` (colour c at bit
    c % 32 of word c // 32)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :num_colors].bool()


def pack(mask: torch.Tensor) -> torch.Tensor:
    """bool ``(V, C)`` → int32 ``(V, ceil(C / 32))`` colour words."""
    v, c = mask.shape
    w = -(-c // 32)
    bits = torch.zeros((v, w * 32), dtype=torch.int64, device=mask.device)
    bits[:, :c] = mask.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, device=mask.device)
    words = (bits.view(v, w, 32) * weights).sum(-1)
    return ((words ^ 0x80000000) - 0x80000000).to(torch.int32)
