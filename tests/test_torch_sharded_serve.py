"""Port ≡ reference for sharded serving on ``torch.distributed``:
`ShardedSketchStore` and `DistributedQueryEngine` on gloo worlds of 2, 3
and 4 CPU processes (`torch_mesh_workers.sharded_serve_world`, one world
per size, two mesh shapes in each: a ``data_parallel`` (D, 1) mesh and a
``graph_parallel`` one with rows split over ``model``).

Each pool's slots equal the reference's single-device `SketchStore` word
for word, and top-k, σ(S), marginal gains and ``best_extension`` equal its
`QueryEngine`'s, on every rank; a snapshot restores onto every other mesh
shape of the world's size, and the reference's own snapshot restores onto
the mesh, with the same answers, each rank holding its (slots, rows)
block of it; the memory budget is per shard;
``refresh(0.5)`` resamples the reference's
slots with the same answers.  The launcher's ``--mesh`` runs
(`run_distributed` at 2×2 and 4×1, the Dx1 stream path) pass on the CPU,
and ``--async --mesh`` names the slice that brings it.
Tolerance: exact (integer words; float answers from the same integers)."""
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.sampling import SamplerSpec as JSpec
from repro.serve.influence import PoolConfig as JPoolConfig
from repro.serve.influence import QueryEngine as JEngine
from repro.serve.influence import SketchStore as JStore
from repro_torch.launch import accel
from repro_torch.launch import serve_influence as tlaunch

import torch_mesh_workers as workers

torch.set_num_threads(1)

SERVE_CASES = {
    2: [dict(shape=[2, 1], diffusion="ic", frontier="dense"),
        dict(shape=[1, 2], diffusion="lt", frontier="sparse")],
    3: [dict(shape=[3, 1], diffusion="lt", frontier="dense"),
        dict(shape=[1, 3], diffusion="ic", frontier="sparse")],
    4: [dict(shape=[2, 2], diffusion="ic", frontier="sparse"),
        dict(shape=[4, 1], diffusion="lt", frontier="sparse"),
        dict(shape=[1, 4], diffusion="ic", frontier="dense")],
}
WORLDS = sorted(SERVE_CASES)
_TMP = tempfile.TemporaryDirectory(prefix="sharded_serve_")


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """Per diffusion: the reference's single-device pool (masks, answers,
    answers after ``refresh(0.5)`` and its slots) and its snapshot's
    directory, saved before the refresh."""
    g = workers.GRAPH
    gj = jcsr.dedupe(jgen.powerlaw_cluster(g["n"], g["degree"],
                                           prob=g["prob"], seed=g["seed"]))
    out = {}
    for diffusion in ("ic", "lt"):
        store = JStore(gj, JPoolConfig(max_batches=32, spec=JSpec(
            diffusion=diffusion, num_colors=workers.COLORS, master_seed=3)))
        store.ensure(workers.POOL_BATCHES)
        engine = JEngine(store)
        ref_dir = os.path.join(_TMP.name, f"reference_{diffusion}")
        store.save(ref_dir)
        answers = workers._answers(engine)
        masks = np.stack([np.asarray(b.visited) for b in store.batches])
        slots = store.refresh(0.5)
        out[diffusion] = dict(masks=masks, answers=answers, dir=ref_dir,
                              refresh_slots=slots,
                              after_refresh=workers._answers(engine))
    return out


@functools.lru_cache(maxsize=None)
def _world(world: int) -> list:
    ref = _reference()
    ckpt = tempfile.mkdtemp(prefix=f"world{world}_", dir=_TMP.name)
    return accel.spawn(workers.sharded_serve_world, world,
                       args=(SERVE_CASES[world], ckpt,
                             {d: ref[d]["dir"] for d in ("ic", "lt")}),
                       device="cpu", timeout_s=300)


def _each(world):
    for rank_out in _world(world):
        for res in rank_out:
            yield res, _reference()[res["diffusion"]]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pool_equals_the_single_device_pool(world):
    for res, ref in _each(world):
        np.testing.assert_array_equal(res["masks"], ref["masks"])
        d, m = res["shape"]
        per = -(-workers.POOL_BATCHES // d)
        assert res["block"] == (per, -(-workers.GRAPH["n"] // m), 2)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_engine_equals_the_query_engine(world):
    for res, ref in _each(world):
        assert res["answers"] == ref["answers"], res["shape"]


@pytest.mark.parametrize("world", WORLDS)
def test_restore_across_mesh_shapes(world):
    for res, ref in _each(world):
        for shape, (answers, masks) in res["restored"].items():
            assert answers == ref["answers"], (res["shape"], shape)
            np.testing.assert_array_equal(masks, ref["masks"])


@pytest.mark.parametrize("world", WORLDS)
def test_restore_of_a_reference_snapshot(world):
    for res, ref in _each(world):
        answers, masks, epoch, nbi = res["from_reference"]
        assert answers == ref["answers"]
        np.testing.assert_array_equal(masks, ref["masks"])
        assert (epoch, nbi) == (0, workers.POOL_BATCHES)


@pytest.mark.parametrize("world", WORLDS)
def test_memory_budget_is_per_shard(world):
    """A budget of 2.5 of a rank's slots admits 2 slots a data shard."""
    for res, _ in _each(world):
        assert res["capacity"] == 2 * res["shape"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_restore_places_each_ranks_block(world):
    """A rank of a restored pool holds its (Bp/D, Vp/M, W) block, V
    padded to a multiple of M."""
    for res, _ in _each(world):
        shape, device, equal = res["placed_block"]
        d, m = res["shape"]
        assert shape == (-(-workers.POOL_BATCHES // d),
                         -(-workers.GRAPH["n"] // m), 2)
        assert device == "cpu" and equal


@pytest.mark.parametrize("world", WORLDS)
def test_refresh_equals_the_single_device_refresh(world):
    for res, ref in _each(world):
        assert res["refresh_slots"] == ref["refresh_slots"]
        assert res["after_refresh"] == ref["after_refresh"]


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_launcher_mesh_smoke_passes(mesh, capfd):
    out = tlaunch.main(["--device", "cpu", "--smoke", "--mesh", mesh,
                        "--backend", "gloo", "--n", "300"])
    assert len(out) == 4 and all(r["passed"] for r in out)
    text = capfd.readouterr().out
    assert "[smoke] PASS" in text and "gloo transport" in text
    if mesh == "2x2":
        assert out[0]["gather_words"]      # the exchange moved words


def test_launcher_stream_smoke_on_a_data_mesh(capfd):
    out = tlaunch.main(["--device", "cpu", "--stream-smoke", "--mesh", "2x1",
                        "--n", "300"])
    assert all(r["passed"] for r in out)
    assert "[stream] PASS" in capfd.readouterr().out


def test_launcher_refuses_async_and_tier_on_a_mesh():
    with pytest.raises(NotImplementedError, match="slice G2"):
        tlaunch.main(["--device", "cpu", "--smoke", "--async",
                      "--mesh", "2x2"])
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--tier", "--mesh", "2x1"])
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--smoke",
                      "--sampler-backend", "graph_parallel"])
    for backend in ("dense", "tiled", "kernel"):
        with pytest.raises(SystemExit, match="samples on one device"):
            tlaunch.main(["--device", "cpu", "--smoke", "--mesh", "2x2",
                          "--sampler-backend", backend])
