"""The plain reference against the port, on CPU tensors at small sizes.

The frozen generator gives the port's edges; the plain sampler's masks and
roots and the plain answers equal the port's bit for bit; the sampler run
with its probabilities in bfloat16 (the control) does not.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bpt_bench.reference import answers, graphgen, ic, rng
from repro_torch.graph import csr, generators
from repro_torch.serve.influence import QueryEngine

SEEDS = (0, 7, 2 ** 31 + 5)
CONFIG = {"vertices": 700, "arcs_per_vertex": 7.0, "mixing": 0.2, "exponent": 2.5,
          "graph_seed": 3, "ic_prob": 0.3, "diffusion": "ic", "backend": "kernel",
          "num_colors": 96, "max_levels": 64}


def _port_graph(n, deg, prob, seed):
    return generators.powerlaw_cluster(n, deg, prob=prob, seed=seed,
                                       device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_generator_gives_the_ports_edges(seed):
    g = _port_graph(3000, 12.0, 0.1, seed)
    src, dst, prob = graphgen.raw_edges(3000, 12.0, prob=0.1, seed=seed)
    order = np.argsort(src, kind="stable")
    psrc, pdst, pprob = g.edges_numpy()
    np.testing.assert_array_equal(src[order], psrc)
    np.testing.assert_array_equal(dst[order], pdst)
    np.testing.assert_array_equal(prob[order], pprob)
    merged = graphgen.merge_parallel(src, dst, prob, 3000)
    dsrc, ddst, dprob = csr.dedupe(g).edges_numpy()
    np.testing.assert_array_equal(merged.src, dsrc)
    np.testing.assert_array_equal(merged.dst, ddst)
    assert merged.prob.tobytes() == dprob.tobytes()


def _store(seed, batches=3, config=CONFIG):
    from bpt_bench import program
    edges = graphgen.deployment_graph(config, seed)
    return edges, program.store(edges, config, seed, batches,
                                torch.device("cpu"))


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_masks_and_roots_equal_the_ports(seed):
    edges, store = _store(seed)
    rev = ic.reverse(edges, "cpu")
    C = CONFIG["num_colors"]
    held = 0
    for b in store.batches:
        want = ic.sample(rev, seed, b.batch_index, C)
        assert torch.equal(ic.unpack(b.visited, C), want)
        np.testing.assert_array_equal(
            np.asarray(b.roots, np.int64),
            rng.roots(seed, b.batch_index, edges.num_vertices, C))
        held += int(want.sum())
    assert held > 10 * C * len(store.batches)     # the sets are not trivial


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_reference_answers_equal_the_ports(seed):
    _, store = _store(seed, batches=5)
    engine = QueryEngine(store, query_slots=4, max_seeds=6)
    pool = store.visited_stack()
    C = CONFIG["num_colors"]
    nv, theta = pool.shape[1], pool.shape[0] * C
    sets = [[3], [10, 400, 9], [1, 2, 3, 4, 5, 6], [699, 0]]
    for s, got in zip(sets, engine.sigma(sets)):
        assert got == answers.estimate(answers.sigma_count(pool, s, C), nv,
                                       theta)
    for s in sets:
        got = engine.marginal_gains(s)
        want = answers.estimate(answers.marginal_counts(pool, s, C, block=2),
                                nv, theta)
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_control_fails_the_compare(seed):
    edges = graphgen.deployment_graph(CONFIG, seed)
    rev = ic.reverse(edges, "cpu")
    off = 0
    for index in range(3):
        want = ic.sample(rev, seed, index, CONFIG["num_colors"])
        low = ic.sample(rev, seed, index, CONFIG["num_colors"],
                        prob_dtype=torch.bfloat16)
        off += int((want != low).sum())
    assert off > 0
