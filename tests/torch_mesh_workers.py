"""Rank programs of the port's CPU mesh tests (`test_torch_distributed.py`,
`test_torch_sharded_serve.py`), run by `repro_torch.launch.accel.spawn` on
gloo worlds of CPU processes.  A module of its own, importing torch and
the port only, so that each rank imports it (by name, from the tests
directory on the path the parent hands down) without the test files' jax.

Each function runs several checks in one world and returns plain numpy
and Python values; the tests compare them with the live reference."""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import rrr, traversal
from repro_torch.distributed import traversal as dtrav
from repro_torch.graph import csr, generators, partition
from repro_torch.launch.mesh import make_mesh
from repro_torch.sampling import SamplerSpec, make_sampler

GRAPH = dict(n=500, degree=6.0, prob=0.3, seed=2)
T, COLORS, BATCHES, K = 32, 64, 5, 4


def graph(dev="cpu"):
    return csr.dedupe(generators.powerlaw_cluster(
        GRAPH["n"], GRAPH["degree"], prob=GRAPH["prob"], seed=GRAPH["seed"],
        device=dev))


def _masks(batches) -> np.ndarray:
    return np.stack([convert.masks_to_numpy(b.visited) for b in batches])


def _trim(words) -> list:
    return [[int(x) for x in np.trim_zeros(np.asarray(w), "b")]
            for w in words]


def distributed_world(rank, dev, world: int, cases: list) -> dict:
    """On one world of ``world`` ranks: the graph_parallel sampler for each
    of ``cases`` (shape, diffusion, frontier, capacity), sample-parallel
    traversal and distributed greedy on a (world, 1) mesh, the
    data_parallel sampler under LT with the sparse frontier, and
    `graph_parallel_traversal` over a (1, world) model axis."""
    g = graph(dev)
    g_rev = csr.transpose(g)
    out: dict = {"rank": rank, "num_edges": g.num_edges, "gp": []}
    for case in cases:
        mesh = make_mesh(case["shape"], ("data", "model"), device=dev)
        spec = SamplerSpec(diffusion=case["diffusion"],
                           backend="graph_parallel", num_colors=COLORS,
                           frontier=case["frontier"],
                           frontier_capacity=case.get("capacity", 0),
                           tile_size=T)
        sampler = make_sampler(g, spec, mesh)
        batches = sampler.sample_many(range(BATCHES))
        out["gp"].append(dict(case, masks=_masks(batches),
                              words=_trim(sampler.last_gather_words),
                              model_calls=mesh.stats["model"]["calls"]))

    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    b = 2 * world
    starts = np.stack([rrr.batch_starts(g.num_vertices, COLORS, 0, i)
                       for i in range(b)])
    seeds = rrr.batch_seeds(0, range(b))
    local = dtrav.sample_parallel_visited(g_rev, starts, seeds, COLORS, mesh)
    out["sp_local_shape"] = tuple(local.shape)
    out["sp_masks"] = convert.masks_to_numpy(mesh.all_gather(local, "data"))
    out["greedy"] = dtrav.distributed_greedy_max_cover(local, K, COLORS,
                                                       mesh)
    dp = make_sampler(g, SamplerSpec(diffusion="lt", backend="data_parallel",
                                     num_colors=COLORS, frontier="sparse",
                                     tile_size=T), mesh)
    out["dp_lt_sparse"] = _masks(dp.sample_many(range(BATCHES)))

    # A values-only delta (tombstones, none at the reversed graph's last
    # slot, which a delete would trim) rebinds graph_parallel in place.
    from repro_torch import stream
    rsrc, rdst, _ = g_rev.edges_numpy()
    delta = stream.EdgeDelta.deletes(rdst[:-1:7], rsrc[:-1:7])
    g2 = stream.apply_delta(g, delta)[0]
    g2_rev = stream.apply_delta(g_rev, delta.reversed())[0]
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    for diffusion in ("ic", "lt"):
        gp = make_sampler(g, SamplerSpec(diffusion=diffusion,
                                         backend="graph_parallel",
                                         num_colors=COLORS, tile_size=T),
                          mesh, g_rev=g_rev)
        gp.sample_many(range(2))
        rebound = gp.rebind(g2, g2_rev)
        out[f"rebind_{diffusion}"] = (rebound is gp,
                                      _masks(rebound.sample_many(range(3))))
    t = torch.full((2,), rank)
    nxt = (rank + 1) % world
    out["comm"] = dict(
        all_gather=mesh.all_gather(t, "model").tolist(),
        ppermute=[mesh.ppermute(t, "model", sh).tolist() for sh in (1, 2)],
        ragged=mesh.ppermute(torch.arange(rank + 1), "model", 1,
                             recv_shape=(nxt + 1,)).tolist(),
        psum=int(mesh.psum(t[:1], ("data", "model"))),
        pmax=int(mesh.pmax(t[:1], "model")),
        broadcast=int(mesh.broadcast(t[:1], "model", world - 1)))
    layout = partition.shard_layout(g_rev, T, world,
                                    mesh.axis_index("model"))
    slots = layout.slot_list(g_rev.edges_numpy()[2],
                             np.arange(g_rev.num_edges, dtype=np.int32), dev)
    vis, levels = dtrav.graph_parallel_traversal(
        layout, slots, starts[0], COLORS, int(seeds[0]), mesh)
    full = mesh.all_gather(vis, "model")[:g.num_vertices]
    out["gpt_mask"] = convert.masks_to_numpy(full)
    out["gpt_levels"] = levels
    out["gpt_single_levels"] = traversal.run_fused(
        g_rev, starts[0], COLORS, int(seeds[0])).stats.levels_run
    return out


def _answers(engine, k: int = K) -> dict:
    seeds, sigma = engine.top_k(k)
    return dict(top_k=(np.asarray(seeds).tolist(), sigma),
                sigma=np.asarray(engine.sigma(SIGMA_SETS)).tolist(),
                gains=np.asarray(engine.marginal_gains([3])).tolist(),
                extension=np.asarray(engine.best_extension([3], 2)).tolist())


SIGMA_SETS = [[1, 2], [5, 50, 99], [7]]
POOL_BATCHES = 12


def pool_config(diffusion: str, backend: str, frontier: str = "dense"):
    from repro_torch.serve.influence import PoolConfig
    return PoolConfig(max_batches=32, spec=SamplerSpec(
        diffusion=diffusion, backend=backend, num_colors=COLORS,
        master_seed=3, frontier=frontier, frontier_capacity=16, tile_size=T))


def sharded_serve_world(rank, dev, cases: list, ckpt_root: str,
                        ref_dirs: dict) -> list:
    """Per case (mesh shape, diffusion, frontier): a `ShardedSketchStore`
    of 12 batches (data_parallel on a (D, 1) mesh, graph_parallel when the
    model axis is split) and its `DistributedQueryEngine`'s answers; the
    pool saved and restored onto every other shape of the world's size;
    the reference's snapshot in ``ref_dirs[diffusion]`` restored onto the
    mesh, and the rank's (slots, rows) block of it; answers after
    ``refresh(0.5)``."""
    import os

    from repro_torch.serve.distributed import (DistributedQueryEngine,
                                               ShardedSketchStore)

    g = graph(dev)
    out = []
    for i, case in enumerate(cases):
        shape = tuple(case["shape"])
        mesh = make_mesh(shape, ("data", "model"), device=dev)
        backend = "graph_parallel" if shape[1] > 1 else "data_parallel"
        cfg = pool_config(case["diffusion"], backend, case["frontier"])
        store = ShardedSketchStore(g, cfg, mesh)
        store.ensure(POOL_BATCHES)
        engine = DistributedQueryEngine(store)
        res = dict(case, masks=_masks(store.batches),
                   block=tuple(store.visited_stack().shape),
                   answers=_answers(engine))
        ckpt = os.path.join(ckpt_root, f"case{i}")
        store.save(ckpt)
        res["restored"] = {}
        for other in cases:
            shape2 = tuple(other["shape"])
            mesh2 = make_mesh(shape2, ("data", "model"), device=dev)
            back2 = "graph_parallel" if shape2[1] > 1 else "data_parallel"
            restored = ShardedSketchStore.restore(
                ckpt, g, pool_config(case["diffusion"], back2,
                                     case["frontier"]), mesh2)
            res["restored"][str(shape2)] = (
                _answers(DistributedQueryEngine(restored)),
                _masks(restored.batches))
        from_ref = ShardedSketchStore.restore(ref_dirs[case["diffusion"]], g,
                                              cfg, mesh)
        res["from_reference"] = (_answers(DistributedQueryEngine(from_ref)),
                                 _masks(from_ref.batches), from_ref.epoch,
                                 from_ref.next_batch_index)
        # The rank's block of the restored pool: its slots, its rows.
        per, lo = from_ref.slots_per_shard, from_ref.slot_offset
        rlo, rows = from_ref.row_offset, from_ref.rows_per_shard
        placed = from_ref.visited_stack()
        want = np.zeros((per, rows, 2), np.uint32)
        part = res["masks"][lo:lo + per, rlo:rlo + rows]
        want[:part.shape[0], :part.shape[1]] = part
        res["placed_block"] = (
            tuple(placed.shape), placed.device.type,
            bool(np.array_equal(convert.masks_to_numpy(placed), want)))
        # Per-shard budget: 2.5 of a rank's (V/M)-row slots a rank.
        per_slot = -(-store.bytes_per_batch // store.row_shards)
        budget = dataclasses.replace(cfg, memory_budget_mb=2.5 * per_slot
                                     / 2 ** 20)
        res["capacity"] = ShardedSketchStore(g, budget, mesh).capacity
        res["refresh_slots"] = store.refresh(0.5)
        res["after_refresh"] = _answers(engine)
        res["staged_bytes"] = mesh.staged_bytes
        out.append(res)
    return out
