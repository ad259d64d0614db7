"""Port ≡ reference for vertex reordering (`repro_torch.graph.reorder`,
`csr.relabel`).

Each heuristic's permutation must equal the reference's exactly, and a
relabelled graph must carry the reference's CSR arrays bit for bit
(padded length included): the reordered graph's tile layout, and so every
quantised draw, depends on both.  The graphs are the reference's
``powerlaw_cluster`` edge lists at two sizes and two seeds, built into one
graph per package from the same arrays; one of them has isolated vertices
appended and padded edges."""
import numpy as np
import pytest
import torch

from repro.core import tiles as jtiles
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.graph import reorder as jreorder
from repro_torch.core import tiles as ttiles
from repro_torch.graph import csr as tcsr
from repro_torch.graph import reorder as treorder

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

# (n, average degree, seed, isolated vertices appended, padded edges)
GRAPHS = {
    "n300-s1": (300, 4.0, 1, 0, 0),
    "n300-s2-isolated-padded": (300, 4.0, 2, 23, 17),
    "n1200-s1": (1200, 6.0, 1, 0, 0),
    "n1200-s2": (1200, 6.0, 2, 0, 0),
}
HEURISTICS = [
    ("identity", {}),
    ("random", {}),
    ("random", {"seed": 5}),
    ("degree", {}),
    ("degree", {"descending": False}),
    ("rcm", {}),
    ("cluster", {}),
    ("cluster", {"rounds": 2, "seed": 3}),
]


def _pair(key):
    """(reference graph, port graph) holding the same CSR arrays."""
    n, deg, seed, isolated, pad = GRAPHS[key]
    g0 = jgen.powerlaw_cluster(n, deg, prob=(0.05, 0.95), seed=seed)
    e = g0.num_edges
    src, dst, prob = (np.asarray(a)[:e] for a in (g0.src, g0.dst, g0.prob))
    v = n + isolated
    pad_to = e + pad if pad else None
    return (jcsr.from_edges(src, dst, prob, v, pad_to=pad_to),
            tcsr.from_edges(src, dst, prob, v, pad_to=pad_to, device="cpu"))


def _assert_same_graph(gj, gt):
    assert gt.num_vertices == gj.num_vertices
    assert gt.num_edges == gj.num_edges
    assert gt.padded_edges == gj.padded_edges
    for name in ("indptr", "src", "dst", "prob"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)), name)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name,kwargs", HEURISTICS,
                         ids=[f"{n}{'-' if k else ''}"
                              f"{'-'.join(f'{a}{b}' for a, b in k.items())}"
                              for n, k in HEURISTICS])
def test_permutation_matches_reference(graph, name, kwargs):
    """Exact: the same permutation, and a permutation of 0..V-1."""
    gj, gt = _pair(graph)
    want = jreorder.HEURISTICS[name](gj, **kwargs)
    got = treorder.HEURISTICS[name](gt, **kwargs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(gt.num_vertices))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_relabel_matches_reference(graph):
    """Exact: every CSR array and the padded length, for a random
    permutation."""
    gj, gt = _pair(graph)
    perm = np.random.default_rng(9).permutation(gt.num_vertices)
    _assert_same_graph(jcsr.relabel(gj, perm), tcsr.relabel(gt, perm))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_apply_cluster_matches_reference(graph):
    """Exact: ``apply`` returns the reference's relabelled graph and
    permutation."""
    gj, gt = _pair(graph)
    g_want, p_want = jreorder.apply(gj, "cluster")
    g_got, p_got = treorder.apply(gt, "cluster")
    np.testing.assert_array_equal(p_got, p_want)
    _assert_same_graph(g_want, g_got)


@pytest.mark.parametrize("n,tile_size", [(1200, 32), (4096, 128)])
def test_cluster_order_needs_fewer_tiles(n, tile_size):
    """Exact counts, equal in both packages: ``cluster`` puts the deduped
    graph's edges into fewer tiles than the identity order."""
    gj = jcsr.dedupe(jgen.powerlaw_cluster(n, 6.0, prob=0.25, seed=7))
    gt = tcsr.dedupe(tcsr.from_edges(
        *(np.asarray(a)[:gj.num_edges] for a in (gj.src, gj.dst, gj.prob)),
        n, device="cpu"))
    counts = {}
    for name in ("identity", "cluster"):
        rj, _ = jreorder.apply(gj, name)
        rt, _ = treorder.apply(gt, name)
        counts[name] = ttiles.edge_slot_map(rt, tile_size)[1]
        assert counts[name] == jtiles.edge_slot_map(rj, tile_size)[1]
    assert counts["cluster"] < counts["identity"], counts
