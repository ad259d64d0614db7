"""Port ≡ reference for the whole slice: sketch pool → micro-batched
top-k / σ(S) / marginal-gain serving → cache → refresh, on the launcher's
default graph, with equal answers and equal pool versions."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import imm as jimm
from repro.launch import serve_influence as jlaunch
from repro.sampling import SamplerSpec as JSpec
from repro.serve import influence as jserve
from repro_torch import convert
from repro_torch import sampling as tsampling
from repro_torch.launch import serve_influence as tlaunch
from repro_torch.serve import influence as tserve

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(**kw):
    """The port launcher's defaults (the reference's), on the CPU."""
    return tlaunch.parse_args(
        ["--device", "cpu"] + [a for k, v in kw.items()
                               for a in (f"--{k.replace('_', '-')}", str(v))])


def _stores(backend="kernel", batches=8):
    args = _args(sampler_backend=backend)
    gj = jlaunch.build_graph(args)
    gt = tlaunch.build_graph(args)
    sj = jserve.SketchStore(gj, jserve.PoolConfig(spec=JSpec(backend="dense")))
    st = tserve.SketchStore(gt, tlaunch.build_config(args))
    sj.ensure(batches)
    st.ensure(batches)
    return args, sj, st


def _assert_same_results(tj, rj, tt, rt):
    assert tj.keys() == tt.keys()
    for kind in tj:
        for a, b in zip(tj[kind], tt[kind]):
            if kind == "top_k":
                np.testing.assert_array_equal(rt[b][0], rj[a][0])
                assert rt[b][1] == rj[a][1]
            else:
                np.testing.assert_array_equal(rt[b], np.asarray(rj[a]))


def _assert_same_pool(sj, st):
    assert st.version == sj.version
    assert st.next_batch_index == sj.next_batch_index
    assert st.batch_epochs == sj.batch_epochs
    assert [b.batch_index for b in st.batches] == \
        [b.batch_index for b in sj.batches]
    np.testing.assert_array_equal(convert.masks_to_numpy(st.visited_stack()),
                                  np.asarray(sj.visited_stack()))


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_served_slice_matches_reference(backend):
    args, sj, st = _stores(backend)
    _assert_same_pool(sj, st)
    ej, et = jserve.QueryEngine(sj), tserve.QueryEngine(st)
    bj = jserve.MicroBatcher(ej, cache=jserve.ResultCache())
    bt = tserve.MicroBatcher(et, cache=tserve.ResultCache())
    tj, rj, _ = jlaunch.serve_mixed_batch(sj, ej, bj, args.k, args.queries)
    tt, rt, _ = tlaunch.serve_mixed_batch(st, et, bt, args.k, args.queries)
    _assert_same_results(tj, rj, tt, rt)
    assert bt.dispatches == bj.dispatches
    # Identical mix again: all cache hits, no dispatch.
    before = bt.dispatches
    tlaunch.serve_mixed_batch(st, et, bt, args.k, args.queries)
    stats = bt.cache.stats()
    assert (stats["hits"], stats["misses"], bt.dispatches) == (13, 13, before)
    # Refresh: the same slots resampled at the same new batch indices.
    assert st.refresh(0.25) == sj.refresh(0.25)
    _assert_same_pool(sj, st)
    tj, rj, _ = jlaunch.serve_mixed_batch(sj, ej, bj, args.k, args.queries)
    tt, rt, _ = tlaunch.serve_mixed_batch(st, et, bt, args.k, args.queries)
    _assert_same_results(tj, rj, tt, rt)
    np.testing.assert_array_equal(et.best_extension([88, 110], 3),
                                  ej.best_extension([88, 110], 3))
    np.testing.assert_array_equal(et.marginal_gains([5]),
                                  ej.marginal_gains([5]))


def test_pool_lifecycle_matches_reference():
    _, sj, st = _stores("dense", batches=4)
    assert st.capacity == sj.capacity and st.bytes_per_batch == \
        sj.bytes_per_batch
    st.visited_stack()
    sj.visited_stack()
    assert st.shrink(2) == sj.shrink(2)
    _assert_same_pool(sj, st)
    st.ensure(5)
    sj.ensure(5)
    _assert_same_pool(sj, st)
    cj, ct = sj.clone(), st.clone()
    assert ct.refresh(0.5) == cj.refresh(0.5)
    _assert_same_pool(cj, ct)
    _assert_same_pool(sj, st)                # the original is untouched
    assert st.shrink(9) == [] and st.version == sj.version
    budget = tserve.SketchStore(st.graph, tserve.PoolConfig(
        memory_budget_mb=0.01))
    assert budget.capacity == jserve.SketchStore(sj.graph, jserve.PoolConfig(
        memory_budget_mb=0.01)).capacity


def test_reference_pool_served_by_port_engine():
    """A pool the reference sampled, carried across by `convert`, gets the
    reference's answers from the port's engine (the reference's plain
    counting path; the port's kernel wrapper runs its plain version on CPU
    tensors)."""
    _, sj, st = _stores("dense", batches=3)
    vis = np.stack([np.asarray(b.visited) for b in sj.batches])
    st.batches = convert.batches_from_numpy(
        vis, np.stack([b.roots for b in sj.batches]),
        [b.batch_index for b in sj.batches], device="cpu")
    st._stack = None
    ej = jserve.QueryEngine(sj, use_kernel=False)
    et = tserve.QueryEngine(st)
    seeds_j, sig_j = ej.top_k(6)
    seeds_t, sig_t = et.top_k(6)
    np.testing.assert_array_equal(seeds_t, seeds_j)
    assert sig_t == sig_j
    sets = [[1, 2, 3], [seeds_j[0]], list(range(8))]
    np.testing.assert_array_equal(et.sigma(sets), ej.sigma(sets))
    np.testing.assert_array_equal(et.marginal_gains([7, 9]),
                                  ej.marginal_gains([7, 9]))
    with pytest.raises(ValueError, match="max_seeds"):
        et.sigma([list(range(9))])


@functools.lru_cache(maxsize=None)
def _reference_smoke_imm():
    """The reference launcher smoke's offline ``run_imm``, on its graph."""
    args = _args()
    return jimm.run_imm(jlaunch.build_graph(args), k=args.k, eps=0.5,
                        spec=JSpec(backend="dense", num_colors=args.colors,
                                   master_seed=args.master_seed),
                        theta_cap=args.theta_cap)


@pytest.mark.parametrize("backend", ["dense", "tiled", "kernel"])
def test_port_launcher_smoke_on_cpu(backend, capsys):
    """The port's launcher smoke gives the reference smoke's IMM result."""
    out = tlaunch.run_single(tlaunch.parse_args(
        ["--device", "cpu", "--smoke", "--sampler-backend", backend]))
    want = _reference_smoke_imm()
    np.testing.assert_array_equal(out["imm"].seeds, want.seeds)
    assert (out["imm"].theta, out["imm"].coverage, out["imm"].num_batches) \
        == (want.theta, want.coverage, want.num_batches)
    assert out["store"].spec.backend == backend
    assert "[smoke] PASS" in capsys.readouterr().out


@pytest.mark.parametrize("knob", [dict(backend="data_parallel",
                                       diffusion="lt"),
                                  dict(backend="graph_parallel",
                                       frontier="sparse"),
                                  dict(backend="data_parallel"),
                                  dict(backend="graph_parallel",
                                       model_axis="model")])
def test_unported_cells_name_their_slice(knob):
    """The mesh backends are ported: without a mesh they raise naming the
    mesh they need, whatever the diffusion and frontier."""
    _, _, st = _stores("dense", batches=1)
    with pytest.raises(ValueError, match="needs a mesh"):
        tsampling.make_sampler(st.graph, tsampling.SamplerSpec(**knob))


def test_package_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(_ROOT, "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
