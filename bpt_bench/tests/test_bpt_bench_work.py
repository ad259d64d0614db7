"""The benchmark's work counter against a brute-force count and against the
port's own formulas."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bpt_bench import work
from bpt_bench.reference import graphgen, ic
from repro_torch.core import tiles
from repro_torch.core.traversal import init_frontier
from repro_torch.graph import csr
from repro_torch.kernels import work as port_work

CONFIG = {"vertices": 900, "arcs_per_vertex": 6.0, "mixing": 0.2, "exponent": 2.5,
          "ic_prob": 0.25, "graph_seed": 4}


@pytest.mark.parametrize("seed,colors", [(1, 64), (5, 100), (9, 256)])
def test_live_draws_equal_a_plain_level_loop(seed, colors):
    edges = graphgen.deployment_graph(CONFIG, seed)
    rev = ic.reverse(edges, "cpu")
    live = []
    visited = ic.sample(rev, seed, 3, colors, live_pairs=live)
    assert len(live) < 64                       # the cap was not reached
    out_degree = torch.from_numpy(
        np.bincount(edges.dst, minlength=edges.num_vertices))
    words = ic.pack(visited)
    draws = int((out_degree * work.row_popcounts(words)).sum())
    assert draws == sum(live) > 0
    folds = int(out_degree[work.row_popcounts(words) > 0].sum())
    assert work.expand_batch_ops(words, out_degree) == \
        draws * work.OPS_PER_DRAW + folds * work.OPS_PER_EDGE_FOLD


@pytest.mark.parametrize("colors", [32, 96, 256])
def test_level_bytes_equal_the_ports_slot_expand(colors):
    edges = graphgen.deployment_graph(CONFIG, 2)
    g = csr.from_edges(edges.src, edges.dst, edges.prob, edges.num_vertices,
                       device="cpu")
    tg = tiles.from_graph(csr.transpose(g))
    slots = tiles.ic_slot_list(tg)
    fr = tiles.pad_mask_rows(
        init_frontier(tg.num_vertices, colors, np.arange(colors) % 50, "cpu"),
        tg.padded_vertices)
    _, port_bytes = port_work.slot_expand(slots, fr, fr.clone(), "ic")
    n_tiles = len(np.unique(edges.src.astype(np.int64) // 128 * 1000
                            + edges.dst // 128))
    assert n_tiles == tg.num_tiles
    ours = work.expand_level_bytes(int((edges.prob > 0).sum()), n_tiles,
                                   tg.padded_vertices, fr.shape[1])
    assert ours == port_bytes
    levels = 7
    assert levels * ours == levels * port_bytes


def test_cover_counts_equals_the_ports():
    visited = torch.zeros((5, 300, 3), dtype=torch.int32)
    for q in (1, 8):
        assert work.cover_counts(5, 300, 3, q) == \
            port_work.cover_counts(visited, q)


def test_bound_takes_the_larger_term():
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 1.0) == pytest.approx(1.0)
