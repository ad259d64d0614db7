"""Port ≡ reference: greedy max-k-cover, the θ bound and offline IMM.

Seeds, θ, batch counts and edge-visit totals are integers and the coverage
is an integer count over θ, so every comparison is exact — including the
first-index tie-breaking of the argmax once the gains saturate."""
import math

import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro.core import imm as jimm
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.serve.influence import PoolConfig as JPoolConfig
from repro.serve.influence import SketchStore as JSketchStore
from repro_torch import convert
from repro_torch import sampling as tsampling
from repro_torch.core import imm as timm
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.serve.influence import PoolConfig as TPoolConfig
from repro_torch.serve.influence import SketchStore as TSketchStore

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _graphs(n=300, seed=7):
    gj = jcsr.dedupe(jgen.powerlaw_cluster(n, 6.0, prob=0.25, seed=seed))
    gt = tcsr.dedupe(tgen.powerlaw_cluster(n, 6.0, prob=0.25, seed=seed,
                                           device="cpu"))
    return gj, gt


def _random_pool(b, v, colors, seed, density):
    rs = np.random.default_rng(seed)
    lanes = rs.random((b, v, -(-colors // 32), 32)) < density
    vis = np.packbits(lanes, axis=-1, bitorder="little").view(np.uint32)
    vis = vis[..., 0]
    if colors % 32:
        vis[..., -1] &= (1 << (colors % 32)) - 1
    return vis


@pytest.mark.parametrize("b,v,colors,k,density",
                         [(2, 300, 64, 8, 0.02), (3, 200, 96, 20, 0.01),
                          (1, 150, 40, 12, 0.05)])
def test_greedy_max_cover_matches_reference(b, v, colors, k, density):
    vis = _random_pool(b, v, colors, seed=k, density=density)
    vt = convert.masks_from_numpy(vis, "cpu")
    sj, cj = jimm.greedy_max_cover(vis, k, colors)
    st, ct = timm.greedy_max_cover(vt, k, colors)
    np.testing.assert_array_equal(st, sj)
    assert ct == cj
    sr, cr = timm.greedy_max_cover_ref(vt, k, colors)
    np.testing.assert_array_equal(sr, np.asarray(
        jimm.greedy_max_cover_ref(vis, k, colors)[0]))
    assert cr == cj
    assert timm.coverage_of(vt, st, colors) == \
        jimm.coverage_of(vis, sj, colors)
    # Resume from a partial cover: the online engine's incremental path.
    aj = jimm.initial_active(b, colors) & ~vis[:, int(sj[0]), :]
    at = convert.masks_from_numpy(np.asarray(aj), "cpu")
    ej, naj, uj = jimm.greedy_extend(vis, aj, 3)
    et, nat, ut = timm.greedy_extend(vt, at, 3)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(convert.masks_to_numpy(nat),
                                  np.asarray(naj))
    assert int(ut) == int(uj)


@pytest.mark.parametrize("n,k,eps", [(300, 4, 0.5), (10_000, 50, 0.1),
                                     (65536, 16, 0.5)])
def test_theta_bounds_match_reference(n, k, eps):
    assert timm.theta_bound(n, k, eps) == jimm.theta_bound(n, k, eps)
    ell = timm._adjusted_ell(n, 1.0)
    assert timm._lam_star_coeff(n, k, ell) == jimm._lam_star_coeff(n, k, ell)
    for theta in (1, 512, 4096, 10 ** 6):
        assert timm.eps_bound_for_theta(n, k, theta, opt_lb=3.0) == \
            jimm.eps_bound_for_theta(n, k, theta, opt_lb=3.0)
    assert math.isfinite(timm.eps_bound_for_theta(n, k, 0))


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_estimate_theta_and_run_imm_match_reference(backend):
    gj, gt = _graphs()
    spec_j = jsampling.SamplerSpec(backend="dense")
    spec_t = tsampling.SamplerSpec(backend=backend)
    thj, bj = jimm.estimate_theta(gj, 4, 0.5, spec=spec_j)
    tht, bt = timm.estimate_theta(gt, 4, 0.5, spec=spec_t)
    assert tht == thj and len(bt) == len(bj)
    for theta_cap in (1024, 300):
        rj = jimm.run_imm(gj, k=4, eps=0.5, spec=spec_j, theta_cap=theta_cap)
        rt = timm.run_imm(gt, k=4, eps=0.5, spec=spec_t, theta_cap=theta_cap)
        np.testing.assert_array_equal(rt.seeds, rj.seeds)
        assert (rt.theta, rt.num_batches, rt.coverage, rt.sigma_estimate) == \
            (rj.theta, rj.num_batches, rj.coverage, rj.sigma_estimate)
        if backend == "dense":     # tile backends do not count edge visits
            assert (rt.fused_edge_visits, rt.unfused_edge_visits) == \
                (rj.fused_edge_visits, rj.unfused_edge_visits)
        else:
            assert rt.fused_edge_visits == rt.unfused_edge_visits == 0
    # Through a fresh pool: the same answer, and the pool keeps the batches.
    pj = JSketchStore(gj, JPoolConfig(spec=spec_j))
    pt = TSketchStore(gt, TPoolConfig(spec=spec_t))
    rj = jimm.run_imm(gj, k=4, eps=0.5, spec=spec_j, theta_cap=1024, pool=pj)
    rt = timm.run_imm(gt, k=4, eps=0.5, spec=spec_t, theta_cap=1024, pool=pt)
    np.testing.assert_array_equal(rt.seeds, rj.seeds)
    assert (rt.theta, rt.coverage) == (rj.theta, rj.coverage)
    assert pt.version == pj.version
    np.testing.assert_array_equal(convert.masks_to_numpy(pt.visited_stack()),
                                  np.asarray(pj.visited_stack()))


def test_run_imm_refuses_small_pool_and_color_mismatch():
    _, gt = _graphs()
    spec = tsampling.SamplerSpec(backend="dense")
    small = TSketchStore(gt, TPoolConfig(spec=spec, max_batches=1))
    with pytest.raises(ValueError, match="capacity"):
        timm.run_imm(gt, k=4, eps=0.3, spec=spec, theta_cap=1024, pool=small)
    other = TSketchStore(gt, TPoolConfig(num_colors=32))
    with pytest.raises(ValueError, match="colors"):
        timm.run_imm(gt, k=4, eps=0.5, num_colors=64, pool=other)
