"""Rank programs of the GPU smoke's mesh phase (``chip_smoke.py`` phase 9d):
the mesh paths at the main configuration, each rank on the card, started
by `launch.accel.spawn` (a program of the package, so that every rank can
import it by name).  Each returns plain values; the smoke prints them and
holds them against ``tests/data/torch_port_golden.json``.

* `rank_main_2x2` — on a 2×2 (data × model) mesh, or the 4×1 one of the
  same four ranks: (a) ``graph_parallel`` IC (batches 0-3 and the top-16
  of their pool, a timed 64-batch pool on the dense and on the sparse
  exchange leg with its per-level words, every level of batch 0 through
  the kernel against the plain version on the rank's slot list, the
  kernels' launches, and the coverage kernels against their plain
  versions on the rank's block of the pool), (b) the same under LT, (c)
  ``data_parallel`` on 4×1 (batches 0-3, top-16, a restore of (a)'s
  snapshot, ``refresh(0.5)`` against a one-device pool, the coverage
  check), (e) the reduced ``"mesh"`` golden's (2, 2)
  cases, and the frontier exchange alone, timed;
* `rank_main_1x3` — (e)'s (1, 3) cases on three ranks;
* `rank_main_1x1` — (d) batches 0-3 through the same code on a 1×1 mesh
  (NCCL), (a)'s snapshot restored onto it, and the coverage check.

Every check against a plain version runs after the launch counts are
read, so its own launches are not counted.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import bitmask
from repro_torch.distributed import traversal as dtrav
from repro_torch.graph import csr, generators
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.sampling import SamplerSpec
from repro_torch.serve.distributed import (DistributedQueryEngine,
                                           ShardedSketchStore)
from repro_torch.serve.influence import PoolConfig, QueryEngine, SketchStore

K = 16


def sha(mask: torch.Tensor) -> str:
    return hashlib.sha256(
        convert.masks_to_numpy(mask).astype("<u4").tobytes()).hexdigest()


def _graph(spec: dict, dev) -> csr.Graph:
    return csr.dedupe(generators.powerlaw_cluster(
        spec["n"], spec["avg_deg"], prob=spec["prob"], seed=spec["seed"],
        device=dev))


def _config(diffusion, backend, frontier="dense", batches=64, colors=64,
            master_seed=0) -> PoolConfig:
    return PoolConfig(max_batches=batches, spec=SamplerSpec(
        diffusion=diffusion, backend=backend, num_colors=colors,
        master_seed=master_seed, frontier=frontier))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else 0.0


def _golden_pool(store, golden_batches, golden_top) -> dict:
    """Batches 0-3 of ``store`` and the top-16 of their pool against the
    golden entries."""
    store.ensure(len(golden_batches))
    shas = [sha(b.visited) for b in store.batches]
    seeds, sigma = DistributedQueryEngine(store).top_k(golden_top["k"])
    n = store.graph.num_vertices
    return dict(
        shas_equal=shas == [b["visited_sha256"] for b in golden_batches],
        top_equal=(seeds.tolist() == golden_top["seeds"]
                   and sigma == golden_top["coverage"] * n),
        seeds=seeds.tolist(), sigma=sigma)


def _levels_against_plain(store, batch_index: int) -> dict:
    """Every level of one batch on this rank's row shard: the kernel and
    the plain version on the same slot list and inputs, level by level
    (the frontier exchanged as the sampler does)."""
    sampler, mesh = store.sampler, store.mesh
    spec, layout, slots = sampler.spec, sampler.layout, sampler.slots
    dev = slots.src_row.device
    fr = dtrav._local_frontier(layout, spec.num_colors,
                               sampler.batch_starts(batch_index), dev)
    seed = sampler.batch_seed(batch_index)
    u = ref.lt_selection_uniforms(seed, layout.rows, spec.num_colors,
                                  row_base=layout.row_base, device=dev) \
        if spec.diffusion == "lt" else None
    vis = torch.zeros_like(fr)
    levels, worst = 0, 0
    while levels < spec.max_iters and int(mesh.pmax(
            torch.count_nonzero(fr).reshape(1), spec.model_axis)) > 0:
        vis = vis | fr
        fr_global = mesh.all_gather(fr, spec.model_axis)
        if u is None:
            got = ops.fused_expand_slots(slots, fr_global, vis, seed, levels)
            want = ref.fused_expand_slots_ref(slots, fr_global, vis, seed,
                                              levels)
        else:
            got = ops.lt_select_expand_slots(slots, fr_global, vis, u)
            want = ref.lt_select_expand_slots_ref(slots, fr_global, vis, u)
        diff = (got.to(torch.int64) & 0xFFFFFFFF) \
            - (want.to(torch.int64) & 0xFFFFFFFF)
        worst = max(worst, int(diff.abs().max()) if diff.numel() else 0)
        fr = got
        levels += 1
    return dict(levels=levels, max_abs_err=worst, entries=slots.num_entries,
                rows=layout.rows, row_base=layout.row_base)


def _cover_against_plain(store, seeds: list) -> dict:
    """``cover_counts`` and ``cover_counts_multi`` on this rank's block of
    the stack against their plain versions, on the masks the engine gives
    them: the all-uncovered tail masks (pad slots zero) and the residual
    masks of the seed-set queries ``seeds[:0]`` … ``seeds[:Q-1]``."""
    eng = DistributedQueryEngine(store)
    vis = store.visited_stack()
    active = eng._initial_active()
    excl_seeds, excl_mask = eng.pad([seeds[:i]
                                     for i in range(eng.query_slots)])
    tail = bitmask.tail_mask_tensor(store.num_colors, vis.device)
    active_q = tail & ~eng._union(vis, excl_seeds, excl_mask) \
        & active[:, None, :]
    one = ops.cover_counts(vis, active).to(torch.int64) \
        - ref.cover_counts_ref(vis, active).to(torch.int64)
    multi = ops.cover_counts_multi(vis, active_q).to(torch.int64) \
        - ref.cover_counts_multi_ref(vis, active_q).to(torch.int64)
    return dict(max_abs_err=max(int(one.abs().max()),
                                int(multi.abs().max())),
                shape=list(vis.shape), queries=int(active_q.shape[1]))


def _exchange_ms(mesh, rows: int, colors: int, reps: int = 20) -> dict:
    """The per-level frontier exchange alone on this mesh, host clock
    around a synchronised run: the dense leg's all-gather of the shard's
    (rows, W) frontier and the butterfly of a frontier with 1 word in 256
    live, with the level's control pmax."""
    dev = mesh.device
    w = bitmask.num_words(colors)
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    dense = torch.randint(-2 ** 31, 2 ** 31, (rows, w),
                          dtype=torch.int32, device=dev, generator=gen)
    tail = dense * (torch.rand(dense.shape, device=dev, generator=gen)
                    < 1 / 256)
    n = rows * w

    def timed(fn):
        fn()
        _sync(dev)
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    s = mesh.axis_size("model")
    return dict(
        dense_ms=timed(lambda: mesh.all_gather(dense, "model")),
        butterfly_ms=timed(lambda: dtrav._scatter_pairs(
            *dtrav._butterfly_exchange(tail, mesh, "model", s, n)[:2],
            rows, w, s)),
        pmax_ms=timed(lambda: mesh.pmax(
            torch.count_nonzero(dense).reshape(1), ("data", "model"))),
        dense_bytes=n * 4, tail_words=int(torch.count_nonzero(tail)))


def _graph_parallel(g, mesh, golden: dict, diffusion: str, ckpt) -> dict:
    """(a) / (b): a graph_parallel pool on ``mesh``, counted launches."""
    dev = mesh.device
    gold = golden if diffusion == "ic" else golden["lt"]
    out = {}
    _reset_peak(dev)
    mesh.reset_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    store = ShardedSketchStore(g, _config(diffusion, "graph_parallel"), mesh)
    out.update(_golden_pool(store, gold["batches"], gold["top_k"]))
    # The 64-batch pool, timed, on the dense exchange leg then the sparse.
    for leg in ("dense", "sparse"):
        pool = ShardedSketchStore(
            g, _config(diffusion, "graph_parallel", leg), mesh)
        _sync(dev)
        mesh.barrier()
        t_b = time.perf_counter()
        pool.ensure(64)
        _sync(dev)
        out[f"build_{leg}_s"] = time.perf_counter() - t_b
        words = pool.sampler.last_gather_words
        out[f"words_{leg}"] = [int(x) for x in
                               np.trim_zeros(words.sum(0), "b")]
        out[f"levels_{leg}"] = [len(np.trim_zeros(w, "b")) for w in words]
        if leg == "dense":
            dense_pool = pool
            if ckpt is not None:
                pool.save(ckpt)
                out["snapshot_top"] = [
                    x.tolist() if isinstance(x, np.ndarray) else x
                    for x in DistributedQueryEngine(pool).top_k(K)]
        else:
            out["sparse_equals_dense"] = all(
                torch.equal(a.visited, b.visited)
                for a, b in zip(pool.batches, dense_pool.batches))
    _sync(dev)
    out["launches"] = dict(ops.LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    out["staged_bytes"] = mesh.staged_bytes
    out["collectives"] = {ax: dict(v) for ax, v in mesh.stats.items()}
    out["check"] = _levels_against_plain(store, 0)
    out["cover_check"] = _cover_against_plain(dense_pool,
                                              gold["top_k"]["seeds"])
    out["peak_gib"] = _peak(dev)
    return out


def _data_parallel(g, mesh, golden: dict, ckpt: str, snapshot_top) -> dict:
    """(c): data_parallel on a 4×1 mesh, a restore of (a)'s snapshot, and
    ``refresh(0.5)`` against a one-device dense pool."""
    dev = mesh.device
    _reset_peak(dev)
    mesh.reset_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    cfg = _config("ic", "data_parallel")
    store = ShardedSketchStore(g, cfg, mesh)
    out = _golden_pool(store, golden["batches"], golden["top_k"])
    restored = ShardedSketchStore.restore(ckpt, g, cfg, mesh)
    seeds, sigma = DistributedQueryEngine(restored).top_k(K)
    out["restore_equal"] = [seeds.tolist(), sigma] == snapshot_top
    del restored
    single = SketchStore(g, _config("ic", "dense"))
    single.ensure(len(store.batches))
    slots = store.refresh(0.5)
    want = single.refresh(0.5)
    s1, sig1 = QueryEngine(single).top_k(K)
    sn, sign = DistributedQueryEngine(store).top_k(K)
    out["refresh_equal"] = (slots == want and np.array_equal(s1, sn)
                            and sig1 == sign and all(
                                torch.equal(a.visited, b.visited.cpu())
                                for a, b in zip(store.batches,
                                                single.batches)))
    out["refresh_slots"] = slots
    _sync(dev)
    out["launches"] = dict(ops.LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    out["staged_bytes"] = mesh.staged_bytes
    out["cover_check"] = _cover_against_plain(store,
                                              golden["top_k"]["seeds"])
    out["peak_gib"] = _peak(dev)
    return out


def _mesh_golden(mesh, mesh_gold: dict) -> dict:
    """(e): the golden ``"mesh"`` cases of this mesh's shape, on its
    reduced graph: per batch the mask's sha256 and the exchange words."""
    dev = mesh.device
    _reset_peak(dev)
    mesh.reset_stats()
    t0 = time.perf_counter()
    g = _graph(mesh_gold["graph"], dev)
    shape = [mesh.axis_size("data"), mesh.axis_size("model")]
    results = []
    for case in mesh_gold["cases"]:
        if case["shape"] != shape:
            continue
        store = ShardedSketchStore(g, _config(
            case["diffusion"], "graph_parallel", case["frontier"],
            batches=len(case["batches"]), colors=mesh_gold["num_colors"],
            master_seed=mesh_gold["master_seed"]), mesh)
        store.ensure(len(case["batches"]))
        words = store.sampler.last_gather_words
        results.append(dict(
            diffusion=case["diffusion"], frontier=case["frontier"],
            shas_equal=[sha(b.visited) for b in store.batches]
            == [b["visited_sha256"] for b in case["batches"]],
            words_equal=[[int(x) for x in np.trim_zeros(w, "b")]
                         for w in words]
            == [b["gather_words"] for b in case["batches"]],
            words=int(words.sum())))
    return dict(cases=results, seconds=time.perf_counter() - t0,
                staged_bytes=mesh.staged_bytes, peak_gib=_peak(dev),
                backend=mesh.backend)


def rank_main_2x2(rank, dev, golden: dict, ckpt: str) -> dict:
    g = _graph(golden["graph"], dev)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    out = {"rank": rank, "backend": mesh.backend, "device": str(dev)}
    out["a"] = _graph_parallel(g, mesh, golden, "ic", ckpt)
    out["b"] = _graph_parallel(g, mesh, golden, "lt", None)
    out["exchange"] = _exchange_ms(mesh, out["a"]["check"]["rows"], 64)
    mesh4 = make_mesh((4, 1), ("data", "model"), device=dev)
    out["c"] = _data_parallel(g, mesh4, golden, ckpt, out["a"]["snapshot_top"])
    out["e"] = _mesh_golden(mesh, golden["mesh"])
    return out


def rank_main_1x3(rank, dev, golden: dict) -> dict:
    mesh = make_mesh((1, 3), ("data", "model"), device=dev)
    return {"rank": rank, "backend": mesh.backend,
            "e": _mesh_golden(mesh, golden["mesh"])}


def rank_main_1x1(rank, dev, golden: dict, ckpt: str,
                  snapshot_top) -> dict:
    """(d): batches 0-3 on a one-rank mesh through the graph_parallel code
    (NCCL), and (a)'s snapshot restored onto it."""
    g = _graph(golden["graph"], dev)
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    _reset_peak(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    cfg = _config("ic", "graph_parallel")
    store = ShardedSketchStore(g, cfg, mesh)
    out = _golden_pool(store, golden["batches"], golden["top_k"])
    _sync(dev)
    out["launches"] = dict(ops.LAUNCHES)
    restored = ShardedSketchStore.restore(ckpt, g, cfg, mesh)
    seeds, sigma = DistributedQueryEngine(restored).top_k(K)
    out["restore_equal"] = [seeds.tolist(), sigma] == snapshot_top
    out.update(rank=rank, backend=mesh.backend, seconds=time.perf_counter()
               - t0, staged_bytes=mesh.staged_bytes)
    out["cover_check"] = _cover_against_plain(store,
                                              golden["top_k"]["seeds"])
    out["peak_gib"] = _peak(dev)
    return out
