"""Rank programs of the GPU smoke's mesh phase (``chip_smoke.py`` phase 9d):
the mesh paths at the main configuration, each rank on the card, started
by `launch.accel.spawn` (a program of the package, so that every rank can
import it by name).  Each returns plain values; the smoke prints them and
holds them against ``tests/data/torch_port_golden.json``.  The smoke runs
them all as jobs of one started world (`rank_jobs`), and the one-rank
NCCL ones in a second (`rank_nccl_1x1`).

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
* `rank_main_1x3` — (e)'s (1, 3) cases on three ranks (or on ranks 0-2 of
  a larger world, the others standing by: `comm.Mesh(members=...)`);
* `rank_main_1x1` — (d) batches 0-3 through the same code on a 1×1 mesh
  (NCCL), (a)'s snapshot restored onto it, and the coverage check;
* `rank_moe_a2a` — the expert-parallel MoE (`mlp._moe_forward_a2a`) on a
  2×2 mesh, each rank holding only its experts, against the golden
  ``"moe_a2a"`` entry; again at capacity factor 64 against the one-device
  scatter; and its all-to-all alone, timed;
* `rank_train_mesh` — sharded training steps (`train.step.make_train_step`
  on a mesh) of the ``"train_mesh"`` golden's models: losses, grad norms,
  every MoE call's expert picks in the reference's token order, each
  rank's shard bytes and, on rank 0, every leaf after the steps (the CPU
  tests run it too);
* `rank_shard_init` — a sharded draw of the weights against the slices of
  the one-device draw, bit for bit, and step 0's gradient of the sharded
  step gathered against the one-device gradient (`_grad_slices`);
  `rank_train_mesh_phase` runs it and `rank_train_mesh` in one world;
* `rank_train_deterministic` — the training launcher's rank with
  deterministic algorithms (the 1x1 NCCL mesh against one device);
  `rank_nccl_1x1` runs (d) and it in one world;
* `rank_train_launcher` — `launch.train.main` on a rank of a started
  world (the launcher runs its ``--mesh`` there);
* `rank_serve_mesh` — LM serving on a mesh (`serve.engine.prefill`, then
  greedy `models.decode.decode_step`s, sequence-parallel): every step's
  logits of every row, the greedy tokens, every MoE call's expert picks
  and router logits in one device's token order, times, ``Mesh.stats``,
  the launches and the peak memory, and for a job with planted faults
  the faults' logits and the split check (GQA or MLA); `serve_one` is the
  same job on one device (the CPU tests run both too);
* `rank_jobs` — several of these, each ``(name, fn, args)``, in turn on
  one started world (`launch.accel.start`);
* `rank_transport_probe` — a gloo collective's and the host staging's
  cost on this host (``scripts/torch_spawn_probe.py``).

Every check against a plain version runs after the launch counts are
read, so its own launches are not counted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import threading
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import bitmask
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import sharding_rules as rules
from repro_torch.distributed import traversal as dtrav
from repro_torch.graph import csr, generators
from repro_torch.kernels import ops, ref
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init as model_init
from repro_torch.models import mlp, model
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


def _graph_parallel(g, mesh, golden: dict, diffusion: str, ckpt,
                    sparse_batches: int = 64):
    """(a) / (b): a graph_parallel pool on ``mesh``, counted launches;
    returns the results and the 64-batch pool of the dense leg (the
    sparse leg builds ``sparse_batches`` of them, held against the dense
    leg's first ones)."""
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
        pool.ensure(64 if leg == "dense" else sparse_batches)
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


def rank_main_2x2(rank, dev, golden: dict, ckpt: str,
                  sparse_batches: int = 64) -> dict:
    g = _graph(golden["graph"], dev)
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    out = {"rank": rank, "backend": mesh.backend, "device": str(dev),
           "sparse_batches": sparse_batches}
    out["a"], pool = _graph_parallel(g, mesh, golden, "ic", ckpt,
                                     sparse_batches)
    out["f"] = _front_end(pool, mesh, ckpt)
    del pool
    out["b"] = _graph_parallel(g, mesh, golden, "lt", None,
                               sparse_batches)[0]
    out["exchange"] = _exchange_ms(mesh, out["a"]["check"]["rows"], 64)
    mesh4 = make_mesh((4, 1), ("data", "model"), device=dev)
    out["c"] = _data_parallel(g, mesh4, golden, ckpt, out["a"]["snapshot_top"])
    out["e"] = _mesh_golden(mesh, golden["mesh"])
    return out


def rank_main_1x3(rank, dev, golden: dict, members=None) -> dict:
    """(e)'s (1, 3) cases: on a world of three ranks, or with ``members``
    on those three ranks of a larger one (the others stand by)."""
    mesh = make_mesh((1, 3), ("data", "model"), device=dev, members=members)
    out = {"rank": rank, "backend": mesh.backend, "member": mesh.member}
    if mesh.member:
        out["e"] = _mesh_golden(mesh, golden["mesh"])
    return out


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
    `mlp.moe_forward` of the whole layer on one device (the scatter; the
    layer assembled from the ranks' experts over ``model``, each drawn
    from its own generator as a whole draw draws it).  The all-to-all over
    ``model`` of one dispatch buffer, timed alone (host clock around
    ``reps`` calls, each synchronised)."""
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
    whole = {k: mesh.all_gather(v.contiguous(), "model")
             if k.startswith("experts_") else v for k, v in local.items()}
    if rank == 0:
        one, _ = mlp.moe_forward(whole, x, cfg64)
        res["cf64_max_abs_diff"] = float((wide - one).abs().max())
        del one
    del whole
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


# ------------------------------------------------------- sharded training
class _Routes:
    """Wraps ``models.mlp._route`` and ``_experts``: records the expert
    picks of every routing call made by a forward (not remat's recompute
    in the backward) and the number of experts each expert call holds."""

    def __init__(self):
        self.orig, self.orig_experts = mlp._route, mlp._experts
        self.picks, self.experts_held = [], set()

    def __call__(self, router, xt, k, mesh=None):
        gate, idx, aux = self.orig(router, xt, k, mesh)
        if torch._C._current_graph_task_id() == -1:
            self.picks.append(idx.detach())
        return gate, idx, aux

    def experts(self, p, buf, cfg):
        self.experts_held.add(int(p["experts_w1"].shape[0]))
        return self.orig_experts(p, buf, cfg)

    def __enter__(self):
        mlp._route, mlp._experts = self, self.experts
        return self

    def __exit__(self, *exc):
        mlp._route, mlp._experts = self.orig, self.orig_experts


def _global_routes(picks: list, cfg, mesh, rows: int, length: int) -> list:
    """Each recorded call's picks, every rank's gathered, as the
    microbatch's (rows · length, k) in token order (on every rank): a2a
    route picks are rank (d, m)'s block (data rank d's rows, sequence
    block m), scatter ones rank q's q-th run of rows."""
    from repro_torch.distributed import fsdp

    out = []
    k = cfg.top_k
    a2a = mlp.a2a_route(cfg, mesh, length)
    r = fsdp.mesh_size(mesh)
    for idx in picks:
        every = fsdp.all_gather_ranks(idx, mesh).cpu()
        full = torch.empty((rows, length, k), dtype=idx.dtype)
        for q in range(r):
            if a2a:
                s = mesh.shape["model"]
                d, m = divmod(q, s)
                blk = rows * s // r
                full[d * blk:(d + 1) * blk,
                     m * (length // s):(m + 1) * (length // s)] = \
                    every[q].view(blk, length // s, k)
            else:
                bl = rows // r
                full[q * bl:(q + 1) * bl] = every[q].view(bl, length, k)
        out.append(full.reshape(-1, k).numpy())
    return out


def train_mesh_cfg(job: dict):
    """The float32 smoke config of a ``make_torch_golden.train_mesh_job``
    and its numpy weights in the reference's layout."""
    cfg = dataclasses.replace(registry.smoke(job["arch"]), dtype="float32")
    tree = model_init.numpy_params(cfg, job["param_seed"])
    if cfg.family in ("ssm", "hybrid"):
        model_init.numpy_ssm_heads(tree, cfg, job["ssm_heads_seed"])
    return cfg, tree


def _train_mesh_job(rank, dev, job: dict) -> dict:
    """The port's sharded step on one job (weights `train_mesh_cfg`'s, the
    shards cut from them): per step loss and grad norm; the expert picks
    of every MoE call in the reference's order; this rank's parameter,
    moment and accumulator bytes beside the bytes its shards should take
    (and the whole model's); the flash launches; rank 0 every leaf after
    the steps at full size."""
    from repro_torch.distributed import fsdp
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    cfg, tree = train_mesh_cfg(job)
    shape = tuple(job["shape"])
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]
    mesh = make_mesh(shape, axes, device=dev, timeout_s=job.get(
        "timeout_s", 120))
    layout = model.layout_on(mesh, cfg)
    params = model.trainable(layout.shard(convert.lm_params_from_jax(
        tree, cfg, dev)))
    del tree
    named = adamw.named(params)
    data = SyntheticLM(cfg, job["batch"], job["seq"], seed=job["data_seed"])
    step = make_train_step(cfg, lambda s: job["lr"], job["microbatches"],
                           mesh=mesh)
    opt = adamw.init(params, torch.float32)
    out = {"rank": rank, "steps": []}
    with _Routes() as routes:
        ops.reset_launches()
        mesh.reset_stats()
        for s in range(job["num_steps"]):
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in data.batch_at(s).items()}
            params, opt, m = step(params, opt, b)
            out["steps"].append({"loss": float(m["loss"]),
                                 "grad_norm": float(m["grad_norm"])})
        grads = layout.sink
        _sync(dev)
        out["launches"] = dict(ops.LAUNCHES)
        out["mesh_stats"] = {a: dict(v) for a, v in mesh.stats.items()}
    out["experts_held"] = sorted(routes.experts_held)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())

    out["bytes"] = dict(
        params=nbytes(named), m=nbytes(opt.m), v=nbytes(opt.v),
        accumulators=nbytes(grads), shards=layout.local_bytes(named),
        accumulators_want=layout.local_bytes(grads),
        whole=sum(math.prod(layout.shapes[k]) * t.element_size()
                  for k, t in named.items()))
    rows = job["batch"] // job["microbatches"]
    out["routes"] = [r.tolist() for r in _global_routes(
        routes.picks, cfg, mesh, rows, job["seq"])]
    leaves = {k: layout.full(k, t.detach()).cpu().numpy()
              for k, t in named.items()}
    if rank == 0:
        out["leaves"] = leaves
    return out


def rank_train_mesh(rank, dev, jobs: list) -> list:
    """`_train_mesh_job` of each ``make_torch_golden.train_mesh_job`` on
    this rank (CPU tests and the card's ``[train mesh golden]`` phase);
    float32 products exactly so (no TF32)."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return [_train_mesh_job(rank, dev, job) for job in jobs]


def rank_shard_init(rank, dev, checks: list, shape, axes,
                    seed: int = 0) -> dict:
    """For each ``(cfg, grad_batch)`` of ``checks``, every leaf drawn
    sharded (`model.init_params` keeping this rank's slices) against the
    same slices of the one-device draw on this rank's device, bit for
    bit: per config, the leaves that differ and the bytes compared.  With
    a ``grad_batch`` (rows, length), then `_grad_slices` of the two
    draws."""
    mesh = make_mesh(tuple(shape), tuple(axes), device=dev)
    out = {"rank": rank, "checks": []}
    for cfg, grad_batch in checks:
        layout = model.layout_on(mesh, cfg)
        sharded = model.init_params(cfg, seed, dev, keep=layout.local)
        whole = model.init_params(cfg, seed, dev)
        shards = dict(sharded.named_parameters())
        differ = [name for name, t in whole.named_parameters()
                  if not torch.equal(layout.local(name, t.data),
                                     shards[name].data)]
        check = dict(name=cfg.name, differ=differ, leaves=len(shards),
                     bytes=sum(t.numel() * t.element_size()
                               for t in shards.values()))
        del shards
        if grad_batch is not None:
            if rank != 0:
                whole = None
            check["grads"] = _grad_slices(sharded, whole, cfg, layout,
                                          *grad_batch, seed)
        out["checks"].append(check)
        del sharded, whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _grad_slices(sharded, whole, cfg, layout, rows: int, length: int,
                 seed: int) -> dict:
    """Step 0's gradient of the sharded step (`train.step.make_train_step`
    on ``sharded``, this rank's shards, lr 0) on ``SyntheticLM(seed +
    1)``'s first batch of ``rows`` x ``length`` tokens, every leaf
    gathered to full size, against the one-device gradient (``whole``,
    the whole model on rank 0: autograd through `model.loss_fn` without a
    mesh): the largest relative L2 difference over the leaves, and as the
    control the smallest over the leaves that a mesh axis splits of the
    same difference with the one-device gradient's blocks rolled by one
    along the leaf's first split dimension (a block on its neighbour's
    rank).  Every rank returns the sharded step's loss and grad norm;
    rank 0 the rest."""
    from repro_torch.models import common
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    mesh, dev = layout.mesh, layout.mesh.device
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in SyntheticLM(cfg, rows, length, seed=seed + 1)
             .batch_at(0).items()}
    params = layout.attach(model.trainable(sharded))
    opt = adamw.init(params, common.dtype_of(cfg.optimizer_state_dtype))
    _, _, m = make_train_step(cfg, lambda s: 0.0, mesh=mesh)(
        params, opt, batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del opt, params
    got = {}
    for k, g in layout.sink.items():
        g = layout.full(k, g)
        if whole is not None:
            got[k] = g
    layout.sink = None
    if whole is None:
        return out
    whole = model.trainable(whole)
    named = dict(whole.named_parameters())
    loss = model.loss_fn(whole, cfg, batch)[0]
    want = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    out.update(one_device_loss=float(loss.detach()), leaves=len(got), err=0.0,
               control=math.inf)
    for (k, p), w in zip(named.items(), want):
        w = torch.zeros_like(p) if w is None else w.float()
        g, norm = got.pop(k).float(), float(w.norm())
        if norm == 0.0:
            continue
        err = float((g - w).norm()) / norm
        if err > out["err"]:
            out.update(err=err, worst_leaf=k)
        split = [d for d, e in enumerate(layout.specs[k]) if e is not None
                 and math.prod(mesh.shape[a] for a in
                               rules.entry_axes(e)) > 1]
        if split:
            d = split[0]
            ways = math.prod(mesh.shape[a] for a in
                             rules.entry_axes(layout.specs[k][d]))
            rolled = torch.roll(w, p.shape[d] // ways, dims=d)
            control = float((g - rolled).norm()) / norm
            if control < out["control"]:
                out.update(control=control, control_leaf=k)
    return out


def rank_train_mesh_phase(rank, dev, jobs: list, checks: list, shape,
                          axes) -> dict:
    """`rank_train_mesh` of ``jobs``, then `rank_shard_init` of
    ``checks``, in one world (the card's ``[train mesh golden]``,
    ``[train mesh shards]`` and ``[train mesh grads]``)."""
    return {"jobs": rank_train_mesh(rank, dev, jobs),
            "shards": rank_shard_init(rank, dev, checks, shape, axes)}


def rank_train_deterministic(rank, dev, argv: list) -> dict:
    """`launch.train`'s rank program on ``argv`` (its ``--mesh``) with
    deterministic algorithms (ops without one warn): the card's ``[train
    mesh nccl]``, whose 1x1 NCCL mesh must equal one device bit for bit,
    and the embedding gradient's atomics would not."""
    from repro_torch.launch import train as tlaunch

    torch.use_deterministic_algorithms(True, warn_only=True)
    return tlaunch._rank_main(rank, dev, tlaunch.parse_args(argv))


def rank_nccl_1x1(rank, dev, golden, ckpt: str, snapshot_top,
                  argv) -> dict:
    """The card's one-rank NCCL world: (d) (`rank_main_1x1`; skipped
    without ``golden``), then ``[train mesh nccl]``
    (`rank_train_deterministic` on ``argv``; skipped without it)."""
    out = {}
    if golden is not None:
        out["d"] = rank_main_1x1(rank, dev, golden, ckpt, snapshot_top)
    if argv is not None:
        out["train"] = rank_train_deterministic(rank, dev, argv)
    return out


def rank_train_launcher(rank, dev, argv: list) -> dict:
    """`launch.train.main(argv)` on this rank of a started world (its
    ``--mesh`` over the world's group: the launcher runs this rank)."""
    from repro_torch.launch import train as tlaunch

    return tlaunch.main(argv)


def rank_transport_probe(rank, dev, sizes: list, reps: int = 5) -> dict:
    """What a rank's collective costs on this host: for each size in
    bytes, host clock (mean of ``reps`` after one warm-up) of an
    all-gather and an all-to-all over the whole default group, each rank
    handing that many bytes (host tensors under gloo, device ones under
    NCCL), and of the copies that stage a device tensor of that size
    through the host (to a pageable and a pinned host buffer, and
    back)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    wire = dev if dist.get_backend() == "nccl" else torch.device("cpu")

    def timed(fn):
        fn()
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    out = {"rank": rank, "world": world, "sizes": []}
    for size in sizes:
        n = size // 4
        host = torch.arange(n, dtype=torch.int32) + rank
        sent = host.to(wire)
        parts = [torch.empty_like(sent) for _ in range(world)]
        a2a = torch.empty(n - n % world, dtype=torch.int32, device=wire)
        row = dict(bytes=n * 4,
                   all_gather_ms=timed(lambda: dist.all_gather(parts, sent)),
                   all_to_all_ms=timed(lambda: dist.all_to_all_single(
                       torch.empty_like(a2a), a2a)))
        if dev.type == "cuda":
            on_dev = host.to(dev)
            pinned = torch.empty_like(host).pin_memory()
            row.update(
                d2h_pageable_ms=timed(lambda: on_dev.to("cpu")),
                d2h_pinned_ms=timed(lambda: pinned.copy_(on_dev)),
                h2d_pageable_ms=timed(lambda: host.to(dev)),
                h2d_pinned_ms=timed(lambda: on_dev.copy_(pinned)))
        out["sizes"].append(row)
    return out


def rank_jobs(rank, dev, jobs: list) -> dict:
    """Several worlds' rank programs in one started world: each ``(name,
    fn, args)`` of ``jobs`` in turn, ``fn(rank, dev, *args)``, with a
    barrier and this rank's cached device memory returned to the card
    between them, and the TF32 switches put back as they were.  Returns
    ``{"results": {name: result}, "times": {name: (start, end)}}``, the
    host's wall clock around each job on this rank."""
    import gc

    import torch.distributed as dist

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    out = {"results": {}, "times": {}}
    for name, fn, args in jobs:
        dist.barrier()
        t0 = time.time()
        out["results"][name] = fn(rank, dev, *args)
        out["times"][name] = (t0, time.time())
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            # the page-locked staging buffers the job's collectives left
            getattr(torch._C, "_host_emptyCache", lambda: None)()
    return out



# --------------------------------------------------------- serving on a mesh
def serve_cfg(job: dict):
    """A serving job's config: the arch's (``"smoke"`` its smoke config)
    with the job's ``cut`` (a dict of field overrides)."""
    cfg = (registry.smoke(job["arch"]) if job.get("smoke")
           else registry.get(job["arch"]))
    return dataclasses.replace(cfg, num_patches=0, **job.get("cut", {}))


def _serve_prompt(cfg, job: dict, dev) -> torch.Tensor:
    rng = np.random.default_rng(job.get("prompt_seed", 0))
    shape = ((job["batch"], cfg.num_codebooks, job["prompt"])
             if cfg.num_codebooks else (job["batch"], job["prompt"]))
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)


def _serve_loop(params, cfg, job: dict, dev, mesh=None) -> dict:
    """``job``'s prefill and greedy decode steps: every step's logits of
    this rank's rows (float32, on the host), the tokens, the prefill
    seconds and the decode seconds a step (host clock, synchronised).
    With ``job["feed"]`` (the global batch's tokens of each step) those
    are fed instead of this run's own greedy picks, which are still
    returned: two runs then decode the same inputs."""
    from repro_torch.models import decode as dec
    from repro_torch.serve import engine

    prompt = _serve_prompt(cfg, job, dev)
    lp = prompt.shape[-1]
    max_len = job.get("max_len") or lp + job["steps"]
    batch = {"tokens": prompt}
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches, _ = engine.prefill(params, cfg, batch, max_len, mesh)
    _sync(dev)
    t1 = time.perf_counter()
    steps, tokens, step_s, fed = [logits.float().cpu().numpy()], [], [], []
    feed = job.get("feed")
    rows = None
    if feed is not None and mesh is not None:
        rows = dec.CacheLayout(mesh, cfg, job["batch"], 1).rows
    for i in range(job["steps"]):
        tok = torch.argmax(logits[:, -1], -1)[..., None]
        tokens.append(tok.cpu().numpy())
        if feed is not None:
            tok = torch.from_numpy(np.asarray(feed[i])).to(dev)
            tok = tok if rows is None else rows(tok)
        fed.append(tok)
        t2 = time.perf_counter()
        logits, caches = dec.decode_step(params, cfg, caches, tok, lp + i,
                                         mesh)
        _sync(dev)
        step_s.append(time.perf_counter() - t2)
        steps.append(logits.float().cpu().numpy())
    return dict(logits=steps, tokens=tokens, prefill_s=t1 - t0,
                decode_ms=1e3 * float(np.median(step_s)) if step_s else 0.0,
                caches=caches, fed=fed, prefill_len=lp)


class _RouterLog:
    """Wraps ``models.mlp._route`` for a serving run: each routing call's
    expert picks (T, k) and router logits (T, E) (float32, the scores
    whose order the picks are), in call order."""

    def __init__(self):
        self.orig, self.calls = mlp._route, []

    def __call__(self, router, xt, k, mesh=None):
        gate, idx, aux = self.orig(router, xt, k, mesh)
        self.calls.append((idx, xt.float() @ router))
        return gate, idx, aux

    def __enter__(self):
        mlp._route = self
        return self

    def __exit__(self, *exc):
        mlp._route = self.orig


def _host_routes(calls) -> list:
    return [(idx.cpu().numpy(), logits.cpu().numpy())
            for idx, logits in calls]


def _mesh_routes(calls, cfg, job: dict, mesh) -> list | None:
    """A mesh run's routing calls (`_RouterLog`) in one device's token
    order, (picks (B·L, k), logits (B·L, E)) a call, on rank 0 (None
    elsewhere; a collective).  A prefill call on the a2a route holds rank
    (d, m)'s block (data position d's rows, sequence block m); any other
    call the rows of the rank's data position, the same on every
    ``model`` rank (every row on every rank when the rows do not
    split)."""
    from repro_torch.distributed import fsdp
    from repro_torch.models import decode as dec

    layout = dec.CacheLayout(mesh, cfg, job["batch"], 1)
    moe_layers = sum(k == "moe" for k in model.layer_kinds(cfg))
    names, dims = mesh.axis_names, [mesh.shape[a] for a in mesh.axis_names]
    ways = math.prod(mesh.shape[a] for a in layout.row_axes)
    b, s = job["batch"], mesh.shape.get("model", 1)
    out = []
    for c, call in enumerate(calls):
        length = job["prompt"] if c < moe_layers else 1
        a2a = bool(layout.row_axes) and mlp.a2a_route(cfg, mesh, length)
        every = [fsdp.all_gather_ranks(t.contiguous(), mesh).cpu().numpy()
                 for t in call]
        if mesh.rank != 0:
            continue
        parts = []
        for t in every:
            full = np.zeros((b, length, t.shape[-1]), t.dtype)
            for q in range(len(t)):
                coord = dict(zip(names, np.unravel_index(q, dims)))
                d = int(np.ravel_multi_index(
                    [coord[a] for a in layout.row_axes],
                    [mesh.shape[a] for a in layout.row_axes])) \
                    if layout.row_axes else 0
                rows = slice(d * b // ways, (d + 1) * b // ways)
                if a2a:
                    m = int(coord["model"])
                    full[rows, m * length // s:(m + 1) * length // s] = \
                        t[q].reshape(b // ways, length // s, -1)
                elif all(int(coord[a]) == 0 for a in names
                         if a not in layout.row_axes):
                    full[rows] = t[q].reshape(b // ways, length, -1)
            parts.append(full.reshape(b * length, -1))
        out.append(tuple(parts))
    return out if mesh.rank == 0 else None


def _faulty_merge(fault: str):
    """`attention.merge_partials` with a planted fault: ``"lost"`` leaves
    every ``model`` rank but 0 out (as if lost), ``"lse"`` weighs every
    rank that sees a key alike (its log-sum-exp taken as 0)."""
    from repro_torch.models import attention

    sound = attention.merge_partials

    def merge(mesh, out, lse):
        if fault == "lost" and mesh.axis_index("model") != 0:
            lse = torch.full_like(lse, float("-inf"))
        elif fault == "lse":
            lse = torch.where(torch.isinf(lse), lse, torch.zeros_like(lse))
        return sound(mesh, out, lse)
    return merge


def _fault_steps(params, cfg, job: dict, res: dict, mesh, dev) -> dict:
    """Planted faults that [serve mesh]'s check must see (`_faulty_merge`):
    after the run, on its caches, steps ``fault_from`` .. ``steps - 1``
    decoded again under each fault, fed the same tokens.  Before
    ``fault_from`` no ``model`` rank but 0 holds a visible key and either
    fault changes nothing, so the steps are those of a run faulty from the
    start (attention layers alone: a state space layer would take its
    steps twice).  Returns per fault each step's logits of this rank's
    rows."""
    from repro_torch.models import attention
    from repro_torch.models import decode as dec

    sound, out = attention.merge_partials, {}
    lp, caches = res["prefill_len"], res["caches"]
    for fault in ("lost", "lse"):
        attention.merge_partials = _faulty_merge(fault)
        try:
            out[fault] = []
            for i in range(job["fault_from"], job["steps"]):
                logits, caches = dec.decode_step(params, cfg, caches,
                                                 res["fed"][i], lp + i, mesh)
                out[fault].append(logits.float().cpu().numpy())
        finally:
            attention.merge_partials = sound
    _sync(dev)
    return out


def _split_check(cfg, job: dict, mesh, dev) -> dict:
    """The sequence split of one decode step's attention on its own, at
    the job's shapes: a seeded cache of ``max_len`` positions and this
    rank's rows (the same on every rank), ``model`` rank r holding
    positions ``[r·Lc, (r+1)·Lc)``; each rank's output and log-sum-exp on
    its keys, merged by `attention.merge_partials` and by each
    `_faulty_merge`, against one device's attention over the whole cache.
    GQA: the ``decode`` kernel on the rank's keys against
    `kernels.ref.flash_attention_ref`; MLA: `attention.mla_partial` of the
    absorbed scores (`attention.mla_scores`) on the rank's latent
    positions against the softmax over all of them, as `mla_decode` takes
    it on one device.  At the run's last step and at the cache's last
    position (on 2 ``model`` ranks, rank 1 sees ``fault_from`` keys at
    the one and Lc at the other).  Returns per case (the visible keys past
    ``model`` rank 0's) the relative RMS of each merge."""
    from repro_torch.models import attention

    gen = torch.Generator(device=dev).manual_seed(11)
    dtype = getattr(torch, cfg.dtype)
    b = job["batch"] // math.prod(mesh.shape[a] for a in mesh.axis_names
                                  if a != "model")
    n, s = job["max_len"], mesh.shape["model"]
    lc = n // s
    base = mesh.axis_index("model") * lc
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    merges = {"sound": attention.merge_partials,
              "lost": _faulty_merge("lost"), "lse": _faulty_merge("lse")}
    if cfg.attention == "mla":
        kr, rd = cfg.kv_lora_rank, cfg.rope_head_dim
        q_lat, q_rope = draw((b, h, kr)).float(), draw((b, h, rd)).float()
        c, k_rope = draw((b, n, kr)).float(), draw((b, n, rd)).float()
        scores = attention.mla_scores(q_lat, q_rope, c, k_rope, cfg)
        pos = torch.arange(n, device=dev)
    else:
        q, k, v = (draw((b, 1, h, d)), draw((b, n, kvh, d)),
                   draw((b, n, kvh, d)))
        own = (k[:, base:base + lc].contiguous(),
               v[:, base:base + lc].contiguous())
    out = {}
    for cur in (job["prompt"] + job["steps"] - 1, n - 1):
        if cfg.attention == "mla":
            want = torch.matmul(torch.softmax(scores.masked_fill(
                pos > cur, float("-inf")), -1), c)
            o, lse = attention.mla_partial(
                scores[..., base:base + lc], pos[base:base + lc] <= cur,
                c[:, base:base + lc])
        else:
            want = ref.flash_attention_ref(q, k, v, causal=True,
                                           kv_offset=cur).float()
            o, lse = ops.flash_attention(q, *own, causal=True,
                                         kv_offset=cur - base,
                                         return_lse=True)
            o, lse = o[:, 0], lse[..., 0]
        row = {}
        for name, merge in merges.items():
            got = merge(mesh, o, lse)
            if cfg.attention != "mla":
                got = got[:, None].to(dtype).float()
            row[name] = float(torch.linalg.vector_norm(got - want)
                              / torch.linalg.vector_norm(want))
        out[cur + 1 - lc] = row
    return out


@torch.inference_mode()
def serve_one(job: dict, dev) -> dict:
    """`rank_serve_mesh`'s job on one device: the same weights (the seeded
    one-device draw), prompt and steps; with every MoE call's picks and
    router logits and the peak device memory."""
    cfg = serve_cfg(job)
    params = model.init_params(cfg, job.get("seed", 0), dev)
    _reset_peak(dev)
    ops.reset_launches()
    with _RouterLog() as log:
        out = _serve_loop(params, cfg, job, dev)
    for key in ("caches", "fed", "prefill_len"):
        del out[key]
    out.update(launches=dict(ops.LAUNCHES), peak_gib=_peak(dev),
               routes=_host_routes(log.calls))
    return out


@torch.inference_mode()
def rank_serve_mesh(rank, dev, jobs: list) -> list:
    """Each job (``arch``, ``smoke``, ``cut``, ``seed``, ``batch``,
    ``prompt``, ``steps``, ``max_len``, ``shape``, ``axes``) on this rank:
    the weights drawn sharded (each leaf's slice of the one-device draw,
    `model.init_params` with the layout's ``local``), the prompt from
    ``prompt_seed``, `engine.prefill` and ``steps`` greedy decode steps on
    the mesh (``feed``: as `_serve_loop`'s).  Returns per job the logits
    of every row at every step (on rank 0; gathered over the data axes),
    each MoE call's picks and router logits (on rank 0, `_mesh_routes`),
    the tokens, the times, the rank's ``Mesh.stats`` and staged bytes of
    the serving run, its launches and its peak memory (GiB), each of the
    serving run alone (the weights' draw excluded); with ``fault_from``,
    `_fault_steps`' logits and `_split_check`'s readings."""
    from repro_torch.models import decode as dec

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for job in jobs:
        cfg = serve_cfg(job)
        mesh = make_mesh(tuple(job["shape"]), tuple(job["axes"]),
                         device=dev, timeout_s=job.get("timeout_s", 300))
        layout = model.layout_on(mesh, cfg)
        params = layout.attach(model.init_params(
            cfg, job.get("seed", 0), dev, keep=layout.local))
        _reset_peak(dev)
        mesh.reset_stats()
        ops.reset_launches()
        with _RouterLog() as log:
            res = _serve_loop(params, cfg, job, dev, mesh)
        launches = dict(ops.LAUNCHES)
        stats = {a: dict(v) for a, v in mesh.stats.items()}
        staged, peak = mesh.staged_bytes, _peak(dev)
        routes = _mesh_routes(log.calls, cfg, job, mesh)
        del log
        faults, split = {}, None
        if job.get("fault_from") is not None:
            faults = _fault_steps(params, cfg, job, res, mesh, dev)
            split = _split_check(cfg, job, mesh, dev)
        for key in ("caches", "fed", "prefill_len"):
            del res[key]
        rows = dec.CacheLayout(mesh, cfg, job["batch"], 1)

        def gather(xs):                 # a collective: every rank calls it
            xs = [rows.gather_rows(torch.from_numpy(x).to(dev)).cpu()
                  .numpy() for x in xs]
            return xs if rank == 0 else None
        out.append(dict(res, logits=gather(res["logits"]),
                        fault_logits={f: gather(x) for f, x in
                                      faults.items()},
                        split=split if rank == 0 else None,
                        routes=routes, rank=rank, mesh_stats=stats,
                        staged_bytes=staged, launches=launches,
                        peak_gib=peak))
        del params, faults
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out
