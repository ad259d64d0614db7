"""Port ≡ reference for the multi-GPU traversal on ``torch.distributed``
(`repro_torch.distributed`, the mesh samplers), on gloo worlds of 1, 2, 3
and 4 CPU processes (`launch.accel.spawn`, one world per size, each
running every check of its size; `torch_mesh_workers.distributed_world`).

* The ``graph_parallel`` sampler (rows over ``model``, batches over
  ``data``), IC and LT, dense and sparse exchange leg — at S = 3 with a
  capacity of 16 words, which sends the tail levels through the butterfly
  — gives masks equal word for word to the reference's single-device
  dense sampler, and per-level ``gather_words`` equal to the reference's
  own ``graph_parallel`` sampler, run in a subprocess with 4 forced host
  devices on meshes with ``Auto`` axes
  (``scripts/make_torch_golden.py::mesh_reference_subprocess``).
* `sample_parallel_visited`, the ``data_parallel`` sampler (LT, sparse
  frontier) and `graph_parallel_traversal` give the single-device masks
  and level count; `distributed_greedy_max_cover` the reference's greedy
  seeds and coverage, on every rank.
* A values-only delta (every 7th edge tombstoned) rebinds the
  ``graph_parallel`` sampler in place, and its masks equal the reference's
  dense sampler on the mutated pair.

The mesh's collectives (`distributed.comm.Mesh`) give their defined
results on every world, a ragged ``ppermute`` included.  The batch count
(5) does not divide 2, 3 or 4: blocks are padded.
Tolerance: exact everywhere (integer words, integer sums)."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import imm as jimm
from repro.core import rrr as jrrr
from repro.core import traversal as jtraversal
from repro import stream as jstream
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.sampling import SamplerSpec as JSpec
from repro.sampling import make_sampler as jmake_sampler
from repro_torch.launch import accel

import torch_mesh_workers as workers

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import make_torch_golden  # noqa: E402

torch.set_num_threads(1)

WORLD_CASES = {
    1: [dict(shape=[1, 1], diffusion="ic", frontier="dense"),
        dict(shape=[1, 1], diffusion="lt", frontier="sparse")],
    2: [dict(shape=[1, 2], diffusion="ic", frontier="sparse"),
        dict(shape=[1, 2], diffusion="lt", frontier="dense"),
        dict(shape=[2, 1], diffusion="ic", frontier="dense")],
    3: [dict(shape=[1, 3], diffusion="ic", frontier="sparse", capacity=16),
        dict(shape=[1, 3], diffusion="lt", frontier="sparse", capacity=16),
        dict(shape=[1, 3], diffusion="ic", frontier="dense")],
    4: [dict(shape=[2, 2], diffusion="ic", frontier="dense"),
        dict(shape=[2, 2], diffusion="ic", frontier="sparse"),
        dict(shape=[2, 2], diffusion="lt", frontier="sparse", capacity=16),
        dict(shape=[1, 4], diffusion="lt", frontier="dense")],
}
WORLDS = sorted(WORLD_CASES)
TIMEOUT_S = 300


@functools.lru_cache(maxsize=None)
def _world(world: int) -> list:
    return accel.spawn(workers.distributed_world, world,
                       args=(world, WORLD_CASES[world]), device="cpu",
                       timeout_s=TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _reference_words() -> dict:
    g = workers.GRAPH
    job = dict(n=g["n"], degree=g["degree"], prob=g["prob"], seed=g["seed"],
               tile_size=workers.T, colors=workers.COLORS,
               batches=workers.BATCHES,
               cases=[c for w in WORLDS for c in WORLD_CASES[w]])
    return {_key(c): [b["gather_words"] for b in c["batches"]]
            for c in make_torch_golden.mesh_reference_subprocess(job)}


def _key(case) -> tuple:
    return (tuple(case["shape"]), case["diffusion"], case["frontier"],
            case.get("capacity", 0))


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """The reference's single-device masks (dense sampler), batch 0's
    level count and the graph."""
    g = workers.GRAPH
    gj = jcsr.dedupe(jgen.powerlaw_cluster(g["n"], g["degree"],
                                           prob=g["prob"], seed=g["seed"]))
    masks = {}
    for diffusion in ("ic", "lt"):
        s = jmake_sampler(gj, JSpec(diffusion=diffusion,
                                    num_colors=workers.COLORS))
        masks[diffusion] = np.stack([np.asarray(b.visited)
                                     for b in s.sample_many(range(8))])
    g_rev = jcsr.transpose(gj)
    levels = int(jtraversal.run_fused(
        g_rev, jrrr.batch_starts(gj.num_vertices, workers.COLORS, 0, 0),
        workers.COLORS, jrrr.batch_seed(0, 0)).stats.levels_run)
    return dict(masks=masks, levels=levels, num_edges=gj.num_edges)


def _u32(masks):
    return np.asarray(masks).view(np.uint32)


@pytest.mark.parametrize("world", WORLDS)
def test_graph_parallel_masks_equal_single_device(world):
    ref = _reference()
    results = _world(world)
    assert all(r["num_edges"] == ref["num_edges"] for r in results)
    for r in results:                       # every rank holds the block
        for case in r["gp"]:
            np.testing.assert_array_equal(
                _u32(case["masks"]),
                ref["masks"][case["diffusion"]][:workers.BATCHES],
                err_msg=f"rank {r['rank']} {_key(case)}")


@pytest.mark.parametrize("world", WORLDS)
def test_gather_words_equal_the_reference(world):
    want = _reference_words()
    for r in _world(world):
        for case in r["gp"]:
            assert case["words"] == want[_key(case)], \
                f"rank {r['rank']} {_key(case)}"


def test_sparse_leg_takes_the_butterfly_at_three_shards():
    """At S = 3 with 16 words of capacity, the early levels take the dense
    all-gather (S(S−1)·rows·W words) and the tail the 2-stage butterfly."""
    rows = 6 * workers.T                      # ceil(16 blocks / 3) blocks
    dense = 3 * 2 * rows * 2
    for case in _world(3)[0]["gp"]:
        if case["frontier"] != "sparse":
            continue
        levels = [w for batch in case["words"] for w in batch]
        assert dense in levels and any(w != dense for w in levels), \
            _key(case)


@pytest.mark.parametrize("world", WORLDS)
def test_sample_parallel_visited_equals_single_device(world):
    ref = _reference()["masks"]["ic"]
    for r in _world(world):
        assert r["sp_local_shape"][0] == 2
        np.testing.assert_array_equal(_u32(r["sp_masks"]),
                                      ref[:2 * world])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_greedy_equals_the_reference(world):
    ref = _reference()["masks"]["ic"][:2 * world]
    seeds, cov = jimm.greedy_max_cover(ref, workers.K, workers.COLORS,
                                       use_kernel=False)
    for r in _world(world):
        got_seeds, got_cov = r["greedy"]
        np.testing.assert_array_equal(got_seeds, np.asarray(seeds))
        assert got_cov == cov


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_lt_sparse_equals_single_device(world):
    ref = _reference()["masks"]["lt"][:workers.BATCHES]
    for r in _world(world):
        np.testing.assert_array_equal(_u32(r["dp_lt_sparse"]), ref)


@pytest.mark.parametrize("world", WORLDS)
def test_graph_parallel_traversal_equals_single_device(world):
    ref = _reference()
    for r in _world(world):
        np.testing.assert_array_equal(_u32(r["gpt_mask"]),
                                      ref["masks"]["ic"][0])
        assert r["gpt_levels"] == r["gpt_single_levels"] == ref["levels"]


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_runs_every_level_on_every_rank(world):
    """Each level's exchange and control collectives run over the model
    axis on every rank, a one-rank model axis included (its one-rank
    groups return the input)."""
    for r in _world(world):
        for case in r["gp"]:
            assert case["model_calls"] > 0, (r["rank"], _key(case))


@functools.lru_cache(maxsize=None)
def _reference_tombstoned() -> dict:
    """The reference's dense masks of batches 0-2 on the graph pair with
    every 7th edge of the reversed graph deleted (tombstoned)."""
    g = workers.GRAPH
    gj = jcsr.dedupe(jgen.powerlaw_cluster(g["n"], g["degree"],
                                           prob=g["prob"], seed=g["seed"]))
    gj_rev = jcsr.transpose(gj)
    rsrc, rdst = np.asarray(gj_rev.src)[:gj.num_edges], \
        np.asarray(gj_rev.dst)[:gj.num_edges]
    delta = jstream.EdgeDelta.deletes(rdst[:-1:7], rsrc[:-1:7])
    g2 = jstream.apply_delta(gj, delta)[0]
    g2_rev = jstream.apply_delta(gj_rev, delta.reversed())[0]
    out = {}
    for diffusion in ("ic", "lt"):
        s = jmake_sampler(g2, JSpec(diffusion=diffusion,
                                    num_colors=workers.COLORS), g_rev=g2_rev)
        out[diffusion] = np.stack([np.asarray(b.visited)
                                   for b in s.sample_many(range(3))])
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_values_only_delta_rebinds_graph_parallel_in_place(world):
    ref = _reference_tombstoned()
    for r in _world(world):
        for diffusion in ("ic", "lt"):
            same, masks = r[f"rebind_{diffusion}"]
            assert same, (r["rank"], diffusion)
            np.testing.assert_array_equal(_u32(masks), ref[diffusion])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_collectives_on_a_model_axis(world):
    """On a (1, world) mesh, rank r holding [r, r]: all_gather concatenates
    in axis order, ppermute by `shift` receives from (r + shift) mod S
    (a ragged one too), psum / pmax reduce, broadcast takes the source's."""
    for r in _world(world):
        rank, c = r["rank"], r["comm"]
        assert c["all_gather"] == [i for i in range(world) for _ in (0, 1)]
        assert c["ppermute"] == [[(rank + sh) % world] * 2 for sh in (1, 2)]
        assert c["ragged"] == list(range((rank + 1) % world + 1))
        assert (c["psum"], c["pmax"], c["broadcast"]) == \
            (sum(range(world)), world - 1, world - 1)


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """`make_mesh` and `accel.spawn` run on the card unless the caller asks
    for the CPU: without a GPU the default raises, before any rank
    starts."""
    from repro_torch.launch.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        accel.spawn(workers.distributed_world, 1, args=(1, []))


def test_run_imm_on_a_one_rank_mesh_equals_the_reference():
    """``run_imm(mesh=...)``'s pool-less sampler on a mesh backend: on a
    one-rank mesh (no process group) both mesh backends give the
    reference's dense-backend seeds, θ and coverage."""
    from repro_torch.core import imm as timm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sampling import SamplerSpec as TSpec

    g = workers.GRAPH
    gj = jcsr.dedupe(jgen.powerlaw_cluster(g["n"], g["degree"],
                                           prob=g["prob"], seed=g["seed"]))
    want = jimm.run_imm(gj, k=3, eps=0.5, theta_cap=1024)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    for backend in ("data_parallel", "graph_parallel"):
        got = timm.run_imm(workers.graph(), k=3, eps=0.5, theta_cap=1024,
                           spec=TSpec(backend=backend, tile_size=workers.T),
                           mesh=mesh)
        np.testing.assert_array_equal(got.seeds, np.asarray(want.seeds))
        assert (got.theta, got.coverage) == (want.theta, want.coverage)
