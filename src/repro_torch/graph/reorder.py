"""Vertex-reordering heuristics (PyTorch port of ``repro.graph.reorder``,
paper §5).

Reordering raises the chance that fused traversals visit shared vertices
around the same time, and it concentrates edges into fewer, denser 128×128
adjacency tiles: on the quantised tile layout it is what lets a
262,144-vertex graph fit one card (``cluster`` halves its tile count).
Every heuristic returns a permutation ``perm`` with ``new_id =
perm[old_id]``.

Host numpy code over the graph's host copies, the reference's line for
line: each permutation equals the reference's, so a reordered graph has the
reference's CSR arrays and tile layout bit for bit.  ``cluster_order``
keeps the reference's sequential label propagation (labels change in place
within a round, in a seeded random visiting order, ties to the smallest
label, through ``np.unique`` and ``np.argmax``), one ``np.unique`` per
vertex and round, so its host time grows with the vertex count.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph import csr


def identity(g: csr.Graph) -> np.ndarray:
    return np.arange(g.num_vertices, dtype=np.int32)


def random_order(g: csr.Graph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    perm = np.arange(g.num_vertices, dtype=np.int32)
    rng.shuffle(perm)
    return perm


def degree_sort(g: csr.Graph, descending: bool = True) -> np.ndarray:
    """new id by outdegree rank — hubs first (paper's degree-based sort)."""
    deg = g.degrees().cpu().numpy()
    order = np.argsort(-deg if descending else deg, kind="stable")
    perm = np.empty_like(order, dtype=np.int32)
    perm[order] = np.arange(len(order), dtype=np.int32)
    return perm


def _undirected_adj(g: csr.Graph):
    """CSR of the symmetrised graph: ``(indptr (V+1,) int64, adj)``, each
    vertex's neighbours in the stable order of the doubled edge list."""
    src, dst, _ = g.edges_numpy()
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    order = np.argsort(s, kind="stable")
    s, d = s[order], d[order]
    indptr = np.zeros(g.num_vertices + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=g.num_vertices), out=indptr[1:])
    return indptr, d


def rcm(g: csr.Graph) -> np.ndarray:
    """Reverse Cuthill–McKee on the symmetrized graph (BFS from low-degree
    roots, neighbors visited in increasing-degree order, order reversed)."""
    indptr, adj = _undirected_adj(g)
    n = g.num_vertices
    deg = indptr[1:] - indptr[:-1]
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    roots = np.argsort(deg, kind="stable")
    for root in roots:
        if visited[root]:
            continue
        visited[root] = True
        order[pos] = root
        head, pos = pos, pos + 1
        while head < pos:
            v = order[head]
            head += 1
            nbrs = adj[indptr[v]:indptr[v + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = np.unique(nbrs)
                nbrs = nbrs[~visited[nbrs]]
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos:pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    order = order[::-1]
    perm = np.empty(n, np.int32)
    perm[order] = np.arange(n, dtype=np.int32)
    return perm


def cluster_order(g: csr.Graph, rounds: int = 5, seed: int = 0) -> np.ndarray:
    """Grappolo-lite: label-propagation communities, then order vertices by
    (community, degree) so cluster members are contiguous in memory."""
    indptr, adj = _undirected_adj(g)
    n = g.num_vertices
    rng = np.random.default_rng(seed)
    labels = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        visit = rng.permutation(n)
        changed = 0
        for v in visit:
            nbrs = adj[indptr[v]:indptr[v + 1]]
            if len(nbrs) == 0:
                continue
            lab, cnt = np.unique(labels[nbrs], return_counts=True)
            best = lab[np.argmax(cnt)]
            if best != labels[v]:
                labels[v] = best
                changed += 1
        if changed == 0:
            break
    deg = indptr[1:] - indptr[:-1]
    order = np.lexsort((-deg, labels))
    perm = np.empty(n, np.int32)
    perm[order] = np.arange(n, dtype=np.int32)
    return perm


HEURISTICS = {
    "identity": identity,
    "random": random_order,
    "degree": degree_sort,
    "rcm": rcm,
    "cluster": cluster_order,
}


def apply(g: csr.Graph, name: str, **kwargs) -> tuple[csr.Graph, np.ndarray]:
    """``(relabelled graph, perm)`` of heuristic ``name``."""
    perm = HEURISTICS[name](g, **kwargs)
    return csr.relabel(g, perm), perm
