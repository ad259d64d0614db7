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
  versions on the rank's block of the pool), (f) the async front end
  over (a)'s 64-batch pool (rank 0 leads, the others follow: answers
  against the engine's own after ``STOP``, launches, dispatch times, the
  whole-mesh broadcast alone and the one-device engine's times), (b) the
  same as (a) under LT, (c)
  ``data_parallel`` on 4×1 (batches 0-3, top-16, a restore of (a)'s
  snapshot, ``refresh(0.5)`` against a one-device pool, the coverage
  check), (e) the reduced ``"mesh"`` golden's (2, 2)
  cases, and the frontier exchange alone, timed;
* `rank_main_1x3` — (e)'s (1, 3) cases on three ranks;
* `rank_main_1x1` — (d) batches 0-3 through the same code on a 1×1 mesh
  (NCCL), (a)'s snapshot restored onto it, and the coverage check;
* `rank_moe_a2a` — the expert-parallel MoE (`mlp._moe_forward_a2a`) on a
  2×2 mesh, each rank holding only its experts, against the golden
  ``"moe_a2a"`` entry; again at capacity factor 64 against the one-device
  scatter; and its all-to-all alone, timed.

Every check against a plain version runs after the launch counts are
read, so its own launches are not counted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import bitmask
from repro_torch.distributed import traversal as dtrav
from repro_torch.graph import csr, generators
from repro_torch.kernels import ops, ref
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init as model_init
from repro_torch.models import mlp
from repro_torch.sampling import SamplerSpec
from repro_torch.serve.distributed import (AsyncFrontEnd,
                                           DistributedQueryEngine, MeshLeader,
                                           ShardedSketchStore, follow)
from repro_torch.serve.distributed.mesh_frontend import message_size
from repro_torch.serve.influence import (MicroBatcher, PoolConfig, QueryEngine,
                                         ResultCache, SketchStore)

K = 16
# (f): the front end's deadline, flush slots, refresh period, clients.
FE_DEADLINE_S, FE_SLOTS, FE_REFRESH_EVERY_S, FE_CLIENTS = 0.05, 8, 1.5, 24


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


def _graph_parallel(g, mesh, golden: dict, diffusion: str, ckpt):
    """(a) / (b): a graph_parallel pool on ``mesh``, counted launches;
    returns the results and the 64-batch pool of the dense leg."""
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
    return out, dense_pool


def _fe_queries(n: int):
    """(f)'s queries: a lone σ, the clients' σ and a marginal's
    exclusions."""
    rng = np.random.default_rng(1)
    lone = rng.integers(0, n, 3).tolist()
    clients = [rng.integers(0, n, 3).tolist() for _ in range(FE_CLIENTS)]
    return lone, clients, rng.integers(0, n, 2).tolist()


def _digest(values) -> str:
    return hashlib.sha256(np.asarray(values, np.float64).tobytes()
                          ).hexdigest()


def _fe_direct(engine, queries) -> dict:
    """Every query of (f) asked of ``engine`` directly (lockstep)."""
    lone, clients, exclude = queries
    sets, q = [lone] + clients, engine.query_slots
    sig = [float(x) for i in range(0, len(sets), q)
           for x in engine.sigma(sets[i:i + q])]
    seeds, sigma = engine.top_k(K)
    return dict(lone=sig[0], clients=sig[1:], top_k=[seeds.tolist(), sigma],
                marginal=_digest(engine.marginal_gains(exclude)))


def _fe_lead(engine, queries) -> dict:
    """Rank 0's side of (f): the front end over a `MeshLeader` serves a
    lone σ, the threaded clients' σ, a top-16 and a marginal query, runs
    at least one background refresh, and closes; the version must then
    hold for a refresh period."""
    lone_q, clients_q, exclude = queries
    with MeshLeader(engine) as leader:
        fe = AsyncFrontEnd(MicroBatcher(leader, cache=ResultCache()),
                           default_deadline=FE_DEADLINE_S,
                           flush_slots=FE_SLOTS,
                           refresh_every=FE_REFRESH_EVERY_S)
        try:
            lone = fe.submit_sigma(lone_q)
            lone.result(timeout=120)
            lone_deadline_flushes = fe.stats.deadline_flushes
            futs = [None] * len(clients_q)

            def client(i):
                futs[i] = fe.submit_sigma(clients_q[i])

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(clients_q))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            top, marg = fe.submit_top_k(K), fe.submit_marginal(exclude)
            answers = dict(
                lone=(lone.result(), lone.pool_version),
                clients=[(f.result(timeout=120), f.pool_version)
                         for f in futs],
                top_k=([top.result(timeout=120)[0].tolist(),
                        top.result()[1]], top.pool_version),
                marginal=(_digest(marg.result(timeout=120)),
                          marg.pool_version))
            end = time.monotonic() + 120
            while fe.stats.refreshes == 0 and time.monotonic() < end:
                time.sleep(0.05)
        finally:
            fe.close()
    closed = engine.store.version
    time.sleep(FE_REFRESH_EVERY_S + 0.1)
    return dict(answers=answers, lone_deadline_flushes=lone_deadline_flushes,
                stats=dataclasses.asdict(fe.stats), version_closed=closed,
                version_later=engine.store.version,
                messages=leader.stats.messages,
                dispatches=leader.stats.dispatches)


def _fe_one_device(directory: str, g, queries, reps: int = 3) -> dict:
    """The pool of ``directory`` restored onto one device: the same
    queries' answers and each flush's host time (mean of ``reps`` after a
    warm-up, each ending in the answer on the host)."""
    lone, clients, exclude = queries
    engine = QueryEngine(SketchStore.restore(directory, g,
                                             _config("ic", "dense")))
    flushes = dict(sigma=lambda: engine.sigma(clients[:FE_SLOTS]),
                   marginal=lambda: engine.marginal_padded(
                       *engine.pad([exclude])),
                   top_k=lambda: engine.top_k(K))
    ms = {}
    for op, fn in flushes.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms[op] = (time.perf_counter() - t0) / reps * 1e3
    return dict(ms=ms, answers=_fe_direct(engine, queries))


def _front_end(store, mesh, ckpt: str) -> dict:
    """(f): the async front end on ``mesh`` over ``store``: rank 0 leads
    (`_fe_lead`), every other rank follows.  After ``STOP``, in lockstep:
    every query asked directly of the engine on the pool as it was before
    the session (a clone) and as it is after it; the whole-mesh broadcast
    of one message alone (host clock, mean of 20); then rank 0 restores the
    final pool onto one device and times the same flushes there."""
    dev = mesh.device
    engine = DistributedQueryEngine(store)
    queries = _fe_queries(store.graph.num_vertices)
    before = store.clone()
    _sync(dev)
    mesh.barrier()
    mesh.reset_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    if mesh.rank == 0:
        out = _fe_lead(engine, queries)
    else:
        st = follow(engine)
        out = dict(messages=st.messages, dispatches=st.dispatches)
    _sync(dev)
    out["launches"] = dict(ops.LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    out["collectives"] = {ax: dict(v) for ax, v in mesh.stats.items()}
    out["staged_bytes"] = mesh.staged_bytes
    out["version"] = store.version
    out["direct"] = {
        before.version: _fe_direct(DistributedQueryEngine(before), queries),
        store.version: _fe_direct(engine, queries)}
    del before
    msg = torch.zeros(message_size(engine), dtype=torch.int32)
    mesh.broadcast(msg, axes=mesh.axis_names)
    mesh.barrier()
    t_b = time.perf_counter()
    for _ in range(20):
        mesh.broadcast(msg, axes=mesh.axis_names)
    out["broadcast_ms"] = (time.perf_counter() - t_b) / 20 * 1e3
    out["message_bytes"] = msg.numel() * msg.element_size()
    directory = os.path.join(ckpt, "frontend")
    store.save(directory)
    if mesh.rank == 0:
        out["one_device"] = _fe_one_device(directory, store.graph, queries)
    mesh.barrier()
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
    out["a"], pool = _graph_parallel(g, mesh, golden, "ic", ckpt)
    out["f"] = _front_end(pool, mesh, ckpt)
    del pool
    out["b"] = _graph_parallel(g, mesh, golden, "lt", None)[0]
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


def _moe_layer(cfg, seed: int, dev, experts=None) -> dict:
    tree = model_init.numpy_moe(cfg, seed, experts)

    def put(t):
        return {k: put(v) if isinstance(v, dict)
                else torch.from_numpy(v).to(dev) for k, v in t.items()}
    return put(tree)


def rank_moe_a2a(rank, dev, gold: dict, reps: int = 20) -> dict:
    """The golden ``"moe_a2a"`` job (deepseek-v3 widths, its expert count
    and seed, float32, TF32 off) on a 2×2 mesh: this rank's experts only,
    `_moe_forward_a2a` on its token block, the blocks gathered; the values
    at the golden's flat indices, aux, the output's magnitude sum, and
    whether its tokens' expert picks are the golden's ``routes``.  Then
    the same at capacity factor 64, and rank 0 holds it against
    `mlp.moe_forward` of the whole layer on one device (the scatter).  The
    all-to-all over ``model`` of one dispatch buffer, timed alone (host
    clock around ``reps`` calls, each synchronised)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    get = registry.smoke if gold.get("smoke") else registry.get
    cfg = dataclasses.replace(get(gold["arch"]),
                              **dict(gold.get("overrides", {}),
                                     dtype="float32"))
    mesh = make_mesh(tuple(gold["shape"]), ("data", "model"), device=dev)
    el = cfg.num_experts // mesh.shape["model"]
    lo = mesh.axis_index("model") * el
    local = _moe_layer(cfg, gold["seed"], dev, range(lo, lo + el))
    x = torch.from_numpy(model_init.numpy_moe_input(
        cfg, gold["seed"], gold["batch"], gold["seq"])).to(dev)
    xb = mlp.token_block(x, mesh)
    picks = mlp._route(local["router"], xb.reshape(-1, cfg.d_model),
                       cfg.top_k)[1]
    want = torch.as_tensor(gold["routes"]).view(
        gold["batch"], gold["seq"], cfg.top_k)
    want = mlp.token_block(want, mesh).reshape(-1, cfg.top_k)
    _reset_peak(dev)
    mesh.reset_stats()
    block, aux = mlp._moe_forward_a2a(local, xb, cfg, mesh)
    _sync(dev)
    stats = {ax: dict(v) for ax, v in mesh.stats.items()}
    staged = mesh.staged_bytes
    out = mlp.gather_tokens(block, mesh).reshape(-1).double()
    flat = torch.as_tensor(gold["flat_ids"], device=dev)
    res = {"rank": rank, "aux": float(aux), "model_stats": stats,
           "routes_equal": bool(torch.equal(picks.cpu(), want)),
           "staged_bytes": staged,
           "values": out[flat].cpu().numpy(),
           "abs_sum": float(out.abs().sum())}
    cfg64 = dataclasses.replace(cfg, capacity_factor=64.0)
    wide = mlp.gather_tokens(mlp._moe_forward_a2a(local, xb, cfg64, mesh)[0],
                             mesh)
    if rank == 0:
        whole = _moe_layer(cfg, gold["seed"], dev)
        one, _ = mlp.moe_forward(whole, x, cfg64)
        res["cf64_max_abs_diff"] = float((wide - one).abs().max())
        del whole, one
    t = xb.shape[0] * xb.shape[1]
    cap = mlp.capacity(t, cfg)
    buf = torch.zeros((mesh.shape["model"], el, cap, cfg.d_model),
                      device=dev)
    mesh.all_to_all(buf, "model")
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_to_all(buf, "model")
        _sync(dev)
    res.update(a2a_ms=1e3 * (time.perf_counter() - t0) / reps,
               a2a_bytes=buf.numel() * buf.element_size(), capacity=cap,
               tokens=t, peak_gib=_peak(dev), backend=mesh.backend)
    return res
