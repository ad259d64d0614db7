"""Influence-query serving launcher (PyTorch port of
``repro.launch.serve_influence``, single device).

    python -m repro_torch.launch.serve_influence --smoke
    python -m repro_torch.launch.serve_influence --smoke --sampler-backend kernel
    python -m repro_torch.launch.serve_influence --device cpu --smoke
    python -m repro_torch.launch.serve_influence --smoke --diffusion lt \
        --frontier sparse --sampler-backend kernel
    python -m repro_torch.launch.serve_influence --tier --smoke --autoscale
    python -m repro_torch.launch.serve_influence --stream-smoke
    python -m repro_torch.launch.serve_influence --smoke --async
    python -m repro_torch.launch.serve_influence --device cpu --smoke \
        --mesh 2x2 --backend gloo
    python -m repro_torch.launch.serve_influence --smoke --mesh 2x2

Samples a sketch pool on a synthetic graph, serves one micro-batched mix of
top-k, σ(S) and marginal-gain queries, and with ``--smoke`` also checks the
pool lifecycle: the pool's first batches equal a reference pool built on
the dense CSR backend with the dense frontier (`dense_variant`, so with
``--frontier sparse`` it is also a sparse ≡ dense check), the identical mix
re-served as 100% cache hits, an epoch refresh that invalidates the cache,
a persist → restore round trip (``--ckpt-dir``, default a temporary
directory it removes) that must give the identical pool, counters and
top-k, and offline ``run_imm`` through a fresh pool equal to the pool-less
run and to the host-loop greedy reference.  ``--device`` defaults to ``cuda``;
``--sampler-backend kernel`` runs every traversal level through the
hand-written CUDA kernels (``fused_expand`` for ``--diffusion ic``,
``lt_select_expand`` for ``lt``), over every tile or, with ``--frontier
sparse``, the level's compacted tile list.
``--tier`` serves through `repro_torch.serve.tier.ServingTier` (per-tenant
admission, replicas, ``--autoscale``) and ``--stream-smoke`` mutates the
graph mid-serve through the tier and checks the incremental pool against a
cold rebuild; ``--async`` fronts the batcher with the deadline-batched
`AsyncFrontEnd`.

``--mesh DxM`` serves from a sharded pool on a (data × model) mesh of D·M
ranks, which the launcher starts itself (`launch.accel.spawn`,
``--backend gloo|nccl`` — gloo for several ranks on one GPU or on the
CPU — with every rank on ``--device``): ``data_parallel`` sampling for
M = 1, ``graph_parallel`` (rows over ``model``) for M > 1.  Every rank runs
`run_distributed`; rank 0 prints.  With ``--smoke`` it checks the sharded
pool and `DistributedQueryEngine` against a one-device dense pool and
`QueryEngine`, the row-split stack, the frontier exchange, a restore onto
half the data axis and a refresh; with ``--stream-smoke --mesh Dx1`` a
graph delta on the sharded pool against a cold rebuild and a one-device
pool.  ``--async`` and ``--tier`` take no mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.checkpoint import manager
from repro_torch.core import imm
from repro_torch.graph import csr, generators
from repro_torch.sampling import SamplerSpec
from repro_torch.serve.influence import (MicroBatcher, PoolConfig, QueryEngine,
                                         ResultCache, SketchStore)


# Pool batches the smoke holds against the dense-CSR, dense-frontier pool.
REFERENCE_BATCHES = 2
# Deadline of a --mesh run: every collective and the join of the ranks.
MESH_TIMEOUT_S = 900.0


def build_graph(args):
    """The launcher's synthetic graph, deduped so every backend samples the
    same edge list (the tile layout needs parallel edges merged)."""
    g = generators.powerlaw_cluster(args.n, args.degree, prob=args.prob,
                                    seed=args.graph_seed, device=args.device)
    return csr.dedupe(g)


def build_config(args, backend: str | None = None) -> PoolConfig:
    """The CLI knobs as a `PoolConfig` with its `SamplerSpec` (``backend``
    overrides ``--sampler-backend``, which defaults to ``dense``)."""
    spec = SamplerSpec(diffusion=args.diffusion,
                       backend=backend or args.sampler_backend or "dense",
                       num_colors=args.colors,
                       master_seed=args.master_seed, frontier=args.frontier,
                       frontier_capacity=args.frontier_capacity)
    return PoolConfig(max_batches=args.max_batches,
                      memory_budget_mb=args.memory_budget_mb, spec=spec)


def build_store(args) -> SketchStore:
    store = SketchStore(build_graph(args), build_config(args))
    store.ensure(args.batches)
    return store


def dense_variant(cfg: PoolConfig) -> PoolConfig:
    """The same pool on the dense CSR backend AND the dense frontier — the
    smoke's reference path."""
    return dataclasses.replace(cfg, spec=dataclasses.replace(
        cfg.spec, backend="dense", frontier="dense"))


def serve_mixed_batch(store, engine, batcher, k: int, num_queries: int):
    """One micro-batched flush mixing all three query kinds."""
    rng = np.random.default_rng(0)
    n = store.graph.num_vertices
    tickets = {"top_k": [batcher.submit_top_k(k)]}
    tickets["sigma"] = [
        batcher.submit_sigma(rng.integers(0, n, rng.integers(1, 5)).tolist())
        for _ in range(num_queries)]
    tickets["marginal"] = [
        batcher.submit_marginal(rng.integers(0, n, 2).tolist())
        for _ in range(num_queries)]
    t0 = time.perf_counter()
    results = batcher.flush()
    dt = time.perf_counter() - t0
    return tickets, results, dt


def _print_mixed(tag, args, tickets, results, dispatches, dt):
    seeds, sigma_topk = results[tickets["top_k"][0]]
    n_served = sum(len(v) for v in tickets.values())
    print(f"[{tag}] mixed batch: {n_served} queries in "
          f"{dispatches} dispatches, {dt:.3f}s")
    print(f"  top-{args.k}: seeds={seeds.tolist()} σ̂={sigma_topk:.1f}")
    print(f"  σ(S) samples: "
          f"{[round(float(results[t]), 1) for t in tickets['sigma'][:3]]}")
    gains = results[tickets["marginal"][0]]
    print(f"  marginal: best vertex {int(np.argmax(gains))} "
          f"Δσ̂={float(np.max(gains)):.1f}")


def run_single(args) -> dict:
    """Sample, serve, and (``--smoke``) check the lifecycle.  Returns what
    ran — store, engine, batcher, the first flush's tickets and results, the
    offline IMM result — and its host-clock timings in seconds."""
    t0 = time.time()
    dev = device_lib.resolve(args.device)
    g = build_graph(args)
    store = SketchStore(g, build_config(args))
    t_build = time.perf_counter()
    store.ensure(args.batches)
    device_lib.synchronize(dev)
    build_s = time.perf_counter() - t_build
    print(f"[serve_influence] pool: {len(store.batches)} batches × "
          f"{store.num_colors} colors = {store.num_samples} RRR sets "
          f"({store.bytes_per_batch * len(store.batches) / 2**20:.2f} MiB, "
          f"capacity {store.capacity} batches; diffusion "
          f"{store.spec.diffusion!r}, backend {store.spec.backend!r}, "
          f"frontier {store.spec.frontier!r} on {dev}) built in "
          f"{build_s:.3f}s")

    engine = QueryEngine(store)
    batcher = MicroBatcher(engine, cache=ResultCache())
    tickets, results, flush_s = serve_mixed_batch(store, engine, batcher,
                                                  args.k, args.queries)
    _print_mixed("serve_influence", args, tickets, results,
                 batcher.dispatches, flush_s)
    out = dict(store=store, engine=engine, batcher=batcher, tickets=tickets,
               results=results, build_s=build_s, flush_s=flush_s)
    if not args.smoke:
        if args.async_frontend:
            out["async"] = _async_demo(args, engine)
        return out

    # ---- the pool's first batches ≡ the dense-CSR, dense-frontier pool
    reference = SketchStore(g, dense_variant(store.config))
    reference.ensure(min(len(store.batches), REFERENCE_BATCHES))
    n_ref = len(reference.batches)
    if not torch.equal(store.visited_stack()[:n_ref],
                       reference.visited_stack()):
        raise AssertionError("pool differs from the dense-CSR, "
                             "dense-frontier reference pool")
    print(f"[smoke] batches 0-{n_ref - 1} equal the dense-CSR, "
          f"dense-frontier reference pool bit for bit")
    del reference

    # ---- cached re-serve + epoch refresh invalidation
    before = batcher.dispatches
    tickets2, again, hit_s = serve_mixed_batch(store, engine, batcher,
                                               args.k, args.queries)
    if batcher.dispatches != before:
        raise AssertionError("identical batch must be all cache hits")
    if any(again[t2] is not results[t1] for kind in tickets
           for t1, t2 in zip(tickets[kind], tickets2[kind])):
        raise AssertionError("cache hits must return the cached answers")
    print(f"[smoke] re-serve: 100% cache hits in {hit_s:.4f}s "
          f"({batcher.cache.hits} hits / {batcher.cache.misses} misses)")
    t_ref = time.perf_counter()
    slots = store.refresh(0.25)
    device_lib.synchronize(dev)
    refresh_s = time.perf_counter() - t_ref
    _, _, reflush_s = serve_mixed_batch(store, engine, batcher, args.k,
                                        args.queries)
    if batcher.dispatches <= before:
        raise AssertionError("refresh must invalidate the cache")
    print(f"[smoke] refresh: epoch {store.epoch}, {len(slots)} slots "
          f"resampled in {refresh_s:.3f}s, cache invalidated; the mix "
          f"recomputed in {reflush_s:.3f}s")
    out.update(persist_restore(args, store, engine))

    # ---- offline IMM through the shared greedy + a fresh pool
    t_imm = time.perf_counter()
    res_plain = imm.run_imm(g, k=args.k, eps=0.5, spec=store.spec,
                            theta_cap=args.theta_cap)
    fresh = SketchStore(g, build_config(args))
    res_pool = imm.run_imm(g, k=args.k, eps=0.5, spec=store.spec,
                           theta_cap=args.theta_cap, pool=fresh)
    imm_s = time.perf_counter() - t_imm
    if not (np.array_equal(res_plain.seeds, res_pool.seeds)
            and res_plain.coverage == res_pool.coverage
            and res_plain.theta == res_pool.theta):
        raise AssertionError(f"pool-routed run_imm {res_pool} != pool-less "
                             f"{res_plain}")
    ref_seeds, ref_cov = imm.greedy_max_cover_ref(
        fresh.visited_stack()[:res_plain.num_batches], args.k, args.colors)
    if not (np.array_equal(res_plain.seeds, ref_seeds)
            and ref_cov == res_plain.coverage):
        raise AssertionError(f"run_imm seeds {res_plain.seeds} != host-loop "
                             f"reference {ref_seeds}")
    print(f"[smoke] offline run_imm (θ={res_plain.theta}, {imm_s:.3f}s): "
          f"pool-routed seeds == pool-less seeds == host-loop reference "
          f"({res_plain.seeds.tolist()})")
    # Async demo last: its background refresh mutates the store, which
    # would invalidate the bit-identity checks above.
    if args.async_frontend:
        out["async"] = _async_demo(args, engine)
    print(f"[smoke] PASS in {time.time() - t0:.1f}s")
    out.update(refresh_slots=slots, refresh_s=refresh_s,
               reflush_s=reflush_s, imm=res_plain,
               imm_pool=res_pool, imm_pool_store=fresh, imm_s=imm_s)
    return out


def persist_restore(args, store: SketchStore, engine: QueryEngine) -> dict:
    """Save the pool, restore it onto the same graph, and require the
    identical stack, counters and top-k; returns the snapshot's size and
    the save and restore seconds.  Without ``--ckpt-dir`` the snapshot
    goes to a temporary directory that is removed afterwards."""
    dev = store.graph.device
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="sketch_pool_")
    try:
        t0 = time.perf_counter()
        store.save(ckpt)
        save_s = time.perf_counter() - t0
        step_dir = os.path.join(ckpt, f"step_{store.epoch:08d}")
        mib = sum(os.path.getsize(os.path.join(step_dir, f))
                  for f in os.listdir(step_dir)) / 2 ** 20
        t0 = time.perf_counter()
        restored = SketchStore.restore(ckpt, store.graph, build_config(args))
        stack = restored.visited_stack()
        device_lib.synchronize(dev)
        restore_s = time.perf_counter() - t0
        counters = manager.restore(ckpt, {"counters": np.zeros(5)},
                                   as_numpy=True)[0]["counters"]
    finally:
        if not args.ckpt_dir:
            shutil.rmtree(ckpt, ignore_errors=True)
    if not torch.equal(stack, store.visited_stack()):
        raise AssertionError("restored pool differs from the saved one")
    mine = [store.epoch, store.next_batch_index, store.master_seed,
            store.num_colors, store.graph_epoch]
    if (counters.tolist() != mine
            or [restored.epoch, restored.next_batch_index,
                restored.master_seed, restored.num_colors,
                restored.graph_epoch] != mine
            or restored.batch_epochs != store.batch_epochs
            or [b.batch_index for b in restored.batches]
            != [b.batch_index for b in store.batches]):
        raise AssertionError(f"restored counters {counters.tolist()} or "
                             f"batch indices differ from the store's {mine}")
    r_seeds, r_sigma = QueryEngine(restored).top_k(args.k)
    s_seeds, s_sigma = engine.top_k(args.k)
    if not (np.array_equal(r_seeds, s_seeds) and r_sigma == s_sigma):
        raise AssertionError(f"restored top-{args.k} {r_seeds} != "
                             f"{s_seeds}")
    print(f"[smoke] persist/restore: {len(store.batches)}-batch snapshot of "
          f"{mib:.2f} MiB saved in {save_s:.3f}s, restored in "
          f"{restore_s:.3f}s: identical stack, counters {mine} and "
          f"top-{args.k}")
    return dict(snapshot_mib=mib, save_s=save_s, restore_s=restore_s)


# -------------------------------------------------------------- distributed
def _parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` → (D, M); ``"D"`` → (D, 1)."""
    parts = text.lower().split("x")
    try:
        d, m = (int(parts[0]), int(parts[1]) if len(parts) > 1 else 1)
    except ValueError:
        d = m = 0
    if len(parts) > 2 or d < 1 or m < 1:
        raise SystemExit(f"--mesh wants DxM with D, M >= 1, got {text!r}")
    return d, m


def _mesh_backend(args, m: int) -> str:
    """The sampler backend of a mesh run: ``--sampler-backend`` if given
    (`main` refuses a one-device backend with ``--mesh``), else
    data_parallel for M = 1, graph_parallel for M > 1."""
    backend = args.sampler_backend or (
        "graph_parallel" if m > 1 else "data_parallel")
    if backend == "graph_parallel" and m < 2:
        raise SystemExit("--sampler-backend graph_parallel wants a model "
                         "axis: use --mesh DxM with M > 1")
    return backend


def run_distributed(args, mesh) -> dict:
    """The sharded lifecycle on ``mesh`` (every rank runs it, in step).

    Builds a `ShardedSketchStore` of ``--batches`` batches, serves one
    mixed flush through `DistributedQueryEngine`, and with ``--smoke``
    checks: top-k and σ(S) (and marginal gains) equal a one-device dense
    pool's `QueryEngine`; each rank holds V/M rows of its slot block; the
    frontier exchange's words per level (graph_parallel); a snapshot
    restored onto half the data axis (``(D/2, 2M)``) answers the same;
    and ``refresh(0.5)`` resamples the same slots as the one-device pool,
    with the same answers.  Returns what ran and its host-clock seconds."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.distributed import (DistributedQueryEngine,
                                               ShardedSketchStore)

    t0 = time.time()
    dev = device_lib.resolve(args.device)
    d, m = mesh.axis_size("data"), mesh.axis_size("model")
    g = build_graph(args)
    cfg = build_config(args, backend=_mesh_backend(args, m))
    store = ShardedSketchStore(g, cfg, mesh)
    t_build = time.perf_counter()
    store.ensure(args.batches)
    device_lib.synchronize(dev)
    build_s = time.perf_counter() - t_build
    per_dev = (store.bytes_per_batch * store.padded_batches
               / store.num_shards / store.row_shards / 2 ** 20)
    print(f"[serve_influence] sharded pool: {len(store.batches)} batches × "
          f"{store.num_colors} colors over {store.num_shards} shards "
          f"(data={d} × model={m} mesh, {mesh.backend} transport on {dev}; "
          f"{per_dev:.2f} MiB/device"
          + (f", visited rows V/{store.row_shards} per device"
             if store.row_shards > 1 else "")
          + f", capacity {store.capacity} batches; diffusion "
          f"{store.spec.diffusion!r}, backend {store.spec.backend!r}, "
          f"frontier {store.spec.frontier!r}) built in {build_s:.3f}s")
    engine = DistributedQueryEngine(store)
    batcher = MicroBatcher(engine, cache=ResultCache())
    tickets, results, flush_s = serve_mixed_batch(store, engine, batcher,
                                                  args.k, args.queries)
    _print_mixed("distributed", args, tickets, results, batcher.dispatches,
                 flush_s)
    out = dict(store=store, engine=engine, build_s=build_s, flush_s=flush_s)
    if not args.smoke:
        return out

    # ---- sharded ≡ single-device, bit for bit
    single = SketchStore(g, dense_variant(cfg))
    single.ensure(len(store.batches))
    ref = QueryEngine(single)
    s1, sig1 = ref.top_k(args.k)
    s_n, sig_n = engine.top_k(args.k)
    sets = [[1, 2], [5, 50, 99]]
    if not (np.array_equal(s1, s_n) and sig1 == sig_n
            and np.array_equal(ref.sigma(sets), engine.sigma(sets))
            and np.array_equal(ref.marginal_gains([3]),
                               engine.marginal_gains([3]))):
        raise AssertionError(f"sharded answers differ from the one-device "
                             f"engine's: top-{args.k} {s_n} vs {s1}")
    print(f"[smoke] sharded == single-device: top-{args.k} seeds "
          f"{s_n.tolist()}, σ̂={sig_n:.1f}, σ(S) and marginal gains "
          f"bit-identical across {store.num_shards} × {store.row_shards} "
          f"shards")
    # ---- row-split pool (M > 1): each rank holds V/M rows
    stack = store.visited_stack()
    if tuple(stack.shape[:2]) != (store.slots_per_shard,
                                  store.rows_per_shard):
        raise AssertionError(f"rank block {tuple(stack.shape)}")
    if store.row_shards > 1:
        print(f"[smoke] row-split stack: each rank holds "
              f"{tuple(stack.shape)} = (Bp/{store.num_shards}, "
              f"Vp/{store.row_shards}, W) of ({store.padded_batches}, "
              f"{store.padded_vertices}, W)")
    gw = getattr(store.sampler, "last_gather_words", None)
    if gw is not None:
        per_level = gw.sum(0)
        print(f"[smoke] frontier exchange ({store.spec.frontier}): "
              f"{[int(x) for x in per_level[:6]]}... packed words/level "
              f"over the model axis, {int(per_level.sum())} total")
    out["gather_words"] = gw

    # ---- elastic restore onto half the data axis
    store.save(args.ckpt_dir)
    d2 = max(d // 2, 1)
    mesh2 = make_mesh((d2, (d * m) // d2), ("data", "model"),
                      device=mesh.device)
    restored = ShardedSketchStore.restore(args.ckpt_dir, g, cfg, mesh2)
    r_seeds, r_sig = DistributedQueryEngine(restored).top_k(args.k)
    if not (np.array_equal(s_n, r_seeds) and sig_n == r_sig):
        raise AssertionError(f"restored top-{args.k} {r_seeds} != {s_n}")
    layout = ShardedSketchStore.saved_layout(args.ckpt_dir)
    print(f"[smoke] elastic restore: {d}x{m} → {d2}x{(d * m) // d2}, "
          f"answers bit-identical (saved layout {layout['shard_layout']})")
    del restored

    # ---- epoch refresh ≡ the one-device pool's
    t_r = time.perf_counter()
    slots = store.refresh(0.5)
    device_lib.synchronize(dev)
    refresh_s = time.perf_counter() - t_r
    slots_single = single.refresh(0.5)
    rs, rsig = engine.top_k(args.k)
    r1, rsig1 = ref.top_k(args.k)
    if not (slots == slots_single and np.array_equal(rs, r1)
            and rsig == rsig1):
        raise AssertionError("refresh differs from the one-device pool's")
    print(f"[smoke] refresh: {len(slots)} slots resampled via "
          f"{store.spec.backend!r} in {refresh_s:.3f}s, still bit-identical "
          f"to the dense single-device pool")
    print(f"[smoke] PASS in {time.time() - t0:.1f}s")
    out.update(refresh_s=refresh_s, passed=True)
    return out


def run_stream_sharded(args, mesh) -> dict:
    """``--stream-smoke --mesh Dx1``: a graph delta on a data_parallel
    `ShardedSketchStore` (every rank in step), checked against a cold
    rebuild and a one-device dense pool on the mutated graph."""
    from repro_torch import stream
    from repro_torch.serve.distributed import (DistributedQueryEngine,
                                               ShardedSketchStore)

    t0 = time.time()
    if mesh.axis_size("model") != 1:
        raise SystemExit("--stream-smoke --mesh wants Dx1 (deltas on "
                         "graph_parallel pools arrive later)")
    rng = np.random.default_rng(args.graph_seed + 1)
    g = build_graph(args)
    cfg = build_config(args, backend="data_parallel")
    store = ShardedSketchStore(g, cfg, mesh)
    store.ensure(args.batches)
    store.visited_stack()
    engine = DistributedQueryEngine(store)
    sig_pre = engine.sigma([[1, 2, 3]])[0]
    tracker = stream.DirtySlotTracker.for_store(store)
    delta = stream.random_delta(g, rng, num_deletes=args.queries,
                                num_inserts=args.queries)
    report = stream.incremental_refresh(store, tracker, delta)
    print(f"[stream] sharded delta: +{report.inserted}/-{report.deleted} "
          f"edges, {report.touched_row_blocks} row-blocks → "
          f"{report.dirty_slots}/{report.total_slots} dirty slots resampled "
          f"in {report.refresh_s:.3f}s (graph epoch {report.graph_epoch})")
    cold = stream.cold_rebuild_batches(store)
    single = SketchStore(store.graph, dense_variant(cfg), g_rev=store.g_rev)
    single.ensure(len(store.batches))
    for bi, bc, bs in zip(store.batches, cold, single.batches):
        if not (torch.equal(bi.visited, bc.visited.cpu())
                and torch.equal(bi.visited, bs.visited.cpu())
                and bi.fused_edge_visits == bc.fused_edge_visits):
            raise AssertionError(f"slot of batch {bi.batch_index} differs "
                                 "from the cold rebuild or the one-device "
                                 "pool")
    sig_post = engine.sigma([[1, 2, 3]])[0]
    print(f"[stream] sharded pool ≡ cold rebuild ≡ single-device dense on "
          f"the mutated graph ({store.num_shards} shards); σ̂(1,2,3) "
          f"{sig_pre:.1f} → {sig_post:.1f}")
    print(f"[stream] PASS in {time.time() - t0:.1f}s")
    return dict(store=store, report=report, passed=True)


def rank_main(rank: int, dev, argv: list) -> dict:
    """One rank of a ``--mesh`` run (the `launch.accel.spawn` target):
    every rank runs the same path; only rank 0 prints.  Returns rank 0's
    summary (the other ranks return their peak device memory only)."""
    import sys
    from repro_torch.launch.mesh import make_mesh

    args = parse_args(argv)
    args.device = str(dev)
    d, m = _parse_mesh(args.mesh)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    try:
        mesh = make_mesh((d, m), ("data", "model"), device=dev)
        run = run_stream_sharded if args.stream_smoke else run_distributed
        out = run(args, mesh)
        summary = {"rank": rank, "passed": bool(out.get("passed")),
                   "staged_bytes": mesh.staged_bytes,
                   "collectives": mesh.stats}
        if "gather_words" in out and out["gather_words"] is not None:
            summary["gather_words"] = out["gather_words"].tolist()
        if dev.type == "cuda":
            summary["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        return summary
    finally:
        if rank != 0:
            sys.stdout.close()
            sys.stdout = sys.__stdout__


def run_mesh(args, argv) -> list:
    """Start the D·M ranks of ``--mesh`` and run `rank_main` on each;
    returns their summaries by rank.  Without ``--ckpt-dir`` the smoke's
    snapshot goes to a temporary directory, removed afterwards."""
    # The ranks import the target by its module path, never as __main__.
    from repro_torch.launch import accel, serve_influence

    d, m = _parse_mesh(args.mesh)
    device_lib.resolve(args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="sharded_pool_")
    print(f"[mesh] {d}x{m} mesh: {d * m} ranks, {args.backend} transport, "
          f"device {args.device}")
    try:
        return accel.spawn(serve_influence.rank_main, d * m,
                           args=(list(argv) + ["--ckpt-dir", ckpt],),
                           backend=args.backend, device=args.device,
                           timeout_s=MESH_TIMEOUT_S)
    finally:
        if not args.ckpt_dir:
            shutil.rmtree(ckpt, ignore_errors=True)


# --------------------------------------------------------------------- tier
def run_tier(args) -> dict:
    """The serving tier: admission → replicas → autoscale → metrics.

    Builds a warm pool, fronts it with `ServingTier` (``--tenants`` tenants,
    tenant0 starved to 0.5 qps, over ``--replicas`` replicas) and drives a
    burst of σ queries.  With ``--smoke`` it checks the tier's contract:
    sheds carry a retry-after, every in-quota answer equals a direct
    `QueryEngine` on a clone, a refresh of one replica never yields a
    mixed-epoch gather, the replicas re-converge bit for bit, and (with
    ``--autoscale``) a scale step keeps the group consistent.  Returns the
    tier's snapshot and what ran."""
    from repro_torch.serve.tier import EpochMixError, ServingTier, ShedError

    t0 = time.time()
    device_lib.resolve(args.device)
    store = build_store(args)
    reference = QueryEngine(store.clone())      # same epoch, direct engine
    autoscale = None
    if args.autoscale:
        autoscale = {"k": args.k, "target_eps": args.target_eps,
                     "target_p99_ms": args.target_p99_ms}
    tier = ServingTier.build(store, replicas=args.replicas,
                             quota_qps=args.quota_qps, autoscale=autoscale,
                             default_deadline=args.deadline)
    out = dict(store=store, tier=tier)
    try:
        tenants = [f"tenant{i}" for i in range(args.tenants)]
        # Tenant 0 is starved so the shed path runs under any load.
        tier.set_quota(tenants[0], rate=0.5, burst=1)
        print(f"[tier] {args.replicas} replicas × {len(store.batches)} "
              f"batches, {args.tenants} tenants (quota {args.quota_qps} qps, "
              f"{tenants[0]} pinned to 0.5 qps)"
              + (", autoscale armed" if autoscale else ""))
        n = store.graph.num_vertices
        rng = np.random.default_rng(2)
        queries = [rng.integers(0, n, 3).tolist() for _ in range(8)]
        sheds, futs = [], []            # futs: (query, future) per admitted
        for q in queries:
            for t in tenants:
                try:
                    futs.append((q, tier.submit_sigma(t, q)))
                except ShedError as e:
                    sheds.append(e)
        values = tier.gather([f for _, f in futs])
        print(f"[tier] {len(futs)} admitted / {len(sheds)} shed; pending "
              f"per replica {tier.group.pending()}")
        if not args.smoke:
            print(tier.to_json(indent=1))
            out["snapshot"] = tier.snapshot()
            return out

        # ---- sheds carry retry-after; in-quota tenants unaffected
        if not sheds or not all(e.retry_after > 0 and e.tenant == tenants[0]
                                for e in sheds):
            raise AssertionError("the starved tenant must shed, with a "
                                 "retry-after, and no other tenant may")
        # ---- in-quota answers ≡ the direct engine on a clone, same epoch
        for (q, _), val in zip(futs, values):
            if val != reference.sigma([q])[0]:
                raise AssertionError("tier answers must equal the direct "
                                     "engine's bit for bit")
        print(f"[smoke] {len(values)} in-quota answers equal the direct "
              f"QueryEngine's; {len(sheds)} sheds with retry-after "
              f"{sheds[0].retry_after:.2f}s")

        # ---- a refresh of one replica: the epoch guard refuses mixes
        before = tier.submit_sigma(tenants[-1], queries[0])
        before.result()
        tier.group.replicas[0].frontend.refresh_now(0.5)    # half a sweep
        after = tier.submit_sigma(tenants[-1], queries[1], deadline=0.0)
        after.result()
        mixed = False
        try:
            tier.gather([before, after])
        except EpochMixError as e:
            mixed = True
            if len(e.versions) != 2:
                raise AssertionError(f"EpochMixError names {e.versions}")
        if not (mixed or before.pool_version == after.pool_version):
            raise AssertionError("mixed-epoch replies must be refused")
        for r in tier.group.replicas[1:]:             # finish the sweep
            r.frontend.refresh_now(0.5)
        stacks = [r.store.visited_stack() for r in tier.group.replicas]
        if not (tier.group.consistent()
                and all(torch.equal(stacks[0], x) for x in stacks[1:])):
            raise AssertionError("replicas must re-converge bit for bit")
        print(f"[smoke] mid-stream refresh: mixed-epoch gather "
              f"{'refused (EpochMixError)' if mixed else 'not provoked'}; "
              f"replicas re-converged bit for bit at "
              f"{tier.group.versions()[0]}")

        # ---- autoscale: scale events swap epochs, never cold-rebuild
        if tier.autoscaler is not None:
            b0 = tier.group.num_batches
            decision = tier.autoscaler.step()
            stacks = [r.store.visited_stack() for r in tier.group.replicas]
            if not (tier.group.consistent()
                    and all(torch.equal(stacks[0], x) for x in stacks[1:])):
                raise AssertionError("the autoscale step left the replicas "
                                     "inconsistent")
            out["decision"] = decision
            print(f"[smoke] autoscale: {decision.action} {b0} → "
                  f"{tier.group.num_batches} batches (ε̂="
                  f"{decision.eps_bound}, θ={decision.theta}) — "
                  f"{decision.reason}")

        snap = tier.snapshot()
        lat = snap["latency"]["all"]
        if snap["totals"]["shed"] != len(sheds) or lat["count"] < len(futs):
            raise AssertionError(f"tier metrics disagree: {snap['totals']}, "
                                 f"{lat['count']} latencies")
        print(f"[smoke] metrics: shed_rate={snap['totals']['shed_rate']:.2f}, "
              f"p50={lat['p50'] * 1e3:.2f}ms p99={lat['p99'] * 1e3:.2f}ms "
              f"over {lat['count']} queries (histogram bucket bounds)")
        out["snapshot"] = snap
    finally:
        tier.close()
    print(f"[smoke] PASS in {time.time() - t0:.1f}s")
    return out


# ---------------------------------------------------------------- streaming
def run_stream(args) -> dict:
    """``--stream-smoke``: mutate the graph mid-serve through the tier
    (2 replicas by default), refresh incrementally, and check the pool
    against a cold rebuild.

    The delta is ``random_delta`` with ``--queries`` deletions and
    ``--queries`` insertions, drawn after the 4 query triples from
    ``default_rng(graph_seed + 1)``, as the reference draws them.  Checks:
    the graph epoch bumps and the replicas agree bit for bit, the pool
    equals `cold_rebuild_batches` word for word (edge visits included),
    a pre/post-delta gather is refused, and a starved tenant's second
    delta is shed.  Returns the report, the cold rebuild's seconds and
    what ran."""
    from repro_torch import stream
    from repro_torch.serve.tier import EpochMixError, ServingTier, ShedError

    t0 = time.time()
    dev = device_lib.resolve(args.device)
    rng = np.random.default_rng(args.graph_seed + 1)
    store = build_store(args)
    tier = ServingTier.build(store, replicas=args.replicas,
                             quota_qps=args.quota_qps,
                             default_deadline=args.deadline)
    out = dict(tier=tier)
    try:
        n = store.graph.num_vertices
        queries = [rng.integers(0, n, 3).tolist() for _ in range(4)]
        pre = [tier.submit_sigma("ops", q) for q in queries]
        pre_vals = tier.gather(pre)
        v0 = tier.group.versions()[0]

        delta = stream.random_delta(store.graph, rng,
                                    num_deletes=args.queries,
                                    num_inserts=args.queries)
        out["delta"] = delta
        if store.spec.diffusion == "lt":
            # The renormalised in-edges of every mutated destination count
            # among the touched rows, beyond the delta's own sources.
            rows = [stream.apply_delta(store.g_rev, delta.reversed(),
                                       lt_normalized=lt_norm)[1].touched_rows
                    for lt_norm in (False, True)]
            if not (set(rows[0]) < set(rows[1])):
                raise AssertionError("LT renormalisation touched no row "
                                     "beyond the delta's own")
            out["lt_touched_rows"] = (len(rows[0]), len(rows[1]))
            print(f"[stream] LT: {len(rows[1])} touched rows on the "
                  f"reversed graph, {len(rows[1]) - len(rows[0])} of them "
                  f"the renormalised in-edges' sources")
        report = tier.apply_delta("ops", delta)
        out["report"] = report
        print(f"[stream] tier delta: +{report.inserted}/-{report.deleted} "
              f"edges, {report.touched_row_blocks} row-blocks → "
              f"{report.dirty_slots}/{report.total_slots} dirty slots "
              f"({report.dirty_fraction:.0%}) in {report.refresh_s:.3f}s "
              f"over {len(tier.group.replicas)} replicas: rebind "
              f"{report.rebind_s:.3f}s, resample {report.resample_s:.3f}s")

        v1 = tier.group.versions()[0]
        stacks = [r.store.visited_stack() for r in tier.group.replicas]
        if not (v1[0] == v0[0] + 1 and tier.group.consistent()
                and all(torch.equal(stacks[0], x) for x in stacks[1:])):
            raise AssertionError(f"replicas disagree after the delta: "
                                 f"{tier.group.versions()}")
        r0 = tier.group.replicas[0].store
        t_cold = time.perf_counter()
        cold = stream.cold_rebuild_batches(r0)
        device_lib.synchronize(dev)
        out["cold_s"] = time.perf_counter() - t_cold
        for bi, bc in zip(r0.batches, cold):
            if not (torch.equal(bi.visited, bc.visited)
                    and bi.fused_edge_visits == bc.fused_edge_visits
                    and bi.unfused_edge_visits == bc.unfused_edge_visits):
                raise AssertionError(f"slot of batch {bi.batch_index} "
                                     "differs from the cold rebuild")
        del cold
        print(f"[stream] replicas converged at graph epoch {v1[0]}; pool ≡ "
              f"cold rebuild on the mutated pair ({len(r0.batches)} slots "
              f"rebuilt cold in {out['cold_s']:.3f}s)")

        post = [tier.submit_sigma("ops", q) for q in queries]
        post_vals = tier.gather(post)
        try:
            tier.gather([pre[0], post[0]])
        except EpochMixError as e:
            if len(e.versions) != 2:
                raise AssertionError(f"EpochMixError names {e.versions}")
        else:
            raise AssertionError("pre/post-delta replies must be refused "
                                 "as a mix")
        print(f"[stream] pre/post-delta gather refused (EpochMixError); "
              f"σ̂ samples {pre_vals[0]:.1f} → {post_vals[0]:.1f}")

        tier.set_quota("vandal", rate=0.01, burst=1)
        tier.apply_delta("vandal", stream.EdgeDelta.deletes([], []))
        try:
            tier.apply_delta("vandal", stream.EdgeDelta.deletes([], []))
        except ShedError as e:
            if not e.retry_after > 0:
                raise AssertionError("a shed delta needs a retry-after")
        else:
            raise AssertionError("the starved tenant's second delta must "
                                 "be shed")
        snap = tier.snapshot()
        s = snap["stream"]
        if not (s["deltas_applied"] == 2
                and s["tracker"]["slots"] == len(r0.batches)):
            raise AssertionError(f"stream metrics disagree: {s}")
        print(f"[stream] admission gates deltas (1 shed); snapshot: "
              f"{s['deltas_applied']} deltas, dirty-fraction p50 "
              f"{s['dirty_fraction']['p50']:.2f}, tracker "
              f"{s['tracker']['tracker_bytes']} B")
        out.update(store=r0, snapshot=snap)
    finally:
        tier.close()
    print(f"[stream] PASS in {time.time() - t0:.1f}s")
    return out


# -------------------------------------------------------------------- async
def _async_demo(args, engine) -> dict:
    """The deadline-batched front end under a burst of threaded clients."""
    from repro_torch.serve.distributed import AsyncFrontEnd

    n = engine.store.graph.num_vertices
    fe = AsyncFrontEnd(MicroBatcher(engine, cache=ResultCache()),
                       default_deadline=args.deadline,
                       refresh_every=args.refresh_every)
    try:
        lone = fe.submit_sigma([1, 2, 3])
        lone.result(timeout=300)
        if fe.stats.deadline_flushes < 1:
            raise AssertionError(f"a lone request must flush on its "
                                 f"deadline: {fe.stats}")
        futs: list = []
        lock = threading.Lock()
        rng = np.random.default_rng(1)
        queries = [rng.integers(0, n, 3).tolist() for _ in range(4 * 8)]

        def client(q):
            f = fe.submit_sigma(q)
            with lock:
                futs.append(f)

        threads = [threading.Thread(target=client, args=(q,))
                   for q in queries]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=300)
        dt = time.perf_counter() - t0
    finally:
        fe.close()
    st = fe.stats
    print(f"[async] {len(queries)} threaded clients + 1 lone request in "
          f"{dt:.2f}s: {st.flushes} flushes ({st.slot_flushes} slot / "
          f"{st.deadline_flushes} deadline / {st.drain_flushes} drain), "
          f"worst queue wait {st.max_queue_wait * 1e3:.0f} ms (deadline "
          f"{args.deadline * 1e3:.0f} ms)")
    return dict(stats=st, seconds=dt)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="full lifecycle check on a synthetic graph")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve from a sharded pool on a (data × model) "
                         "mesh of D·M ranks started by the launcher")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="the mesh's transport: gloo (CPU ranks, or "
                         "several ranks on one GPU, staged through the "
                         "host) or nccl (one GPU per rank)")
    ap.add_argument("--async", dest="async_frontend", action="store_true",
                    help="front the batcher with the deadline-batched "
                         "AsyncFrontEnd and drive it from client threads")
    ap.add_argument("--tier", action="store_true",
                    help="serve through the tier: per-tenant admission "
                         "control + replica routing (+ --autoscale)")
    ap.add_argument("--stream-smoke", action="store_true",
                    help="mutate the graph mid-serve through the tier, "
                         "refresh the pool incrementally and check it "
                         "against a cold rebuild")
    ap.add_argument("--tenants", type=int, default=3,
                    help="tier tenant count (tenant0 is quota-starved)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="tier engine replicas over one epoch-tagged pool")
    ap.add_argument("--autoscale", action="store_true",
                    help="arm the pool autoscaler (coverage-error bound + "
                         "query p99)")
    ap.add_argument("--quota-qps", type=float, default=50.0,
                    help="default per-tenant admission rate (tokens/s)")
    ap.add_argument("--target-eps", type=float, default=0.35,
                    help="autoscale coverage-error target (IMM ε)")
    ap.add_argument("--target-p99-ms", type=float, default=250.0,
                    help="autoscale query-latency target")
    ap.add_argument("--deadline", type=float, default=0.05,
                    help="async flush deadline in seconds")
    ap.add_argument("--refresh-every", type=float, default=None,
                    help="async background refresh period in seconds")
    ap.add_argument("--ckpt-dir", default=None,
                    help="pool snapshot directory (default: a temporary "
                         "directory, removed after the check)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs every "
                         "kernel's plain PyTorch version)")
    ap.add_argument("--diffusion", choices=("ic", "lt"), default="ic",
                    help="diffusion model the pool samples under")
    ap.add_argument("--sampler-backend", default=None,
                    choices=("dense", "tiled", "kernel", "data_parallel",
                             "graph_parallel"),
                    help="traversal backend: CSR sweep, or the tile "
                         "expansion through the CUDA tile kernels "
                         "(tiled and kernel are the same backend); on a "
                         "mesh data_parallel (default for Dx1) or "
                         "graph_parallel (default for M > 1).  Default "
                         "dense")
    ap.add_argument("--frontier", choices=("dense", "sparse"),
                    default="dense",
                    help="sparse: compact each level to the active part of "
                         "the graph (edge blocks on the dense backend, the "
                         "tile list on tiled/kernel); bit-identical to "
                         "dense")
    ap.add_argument("--frontier-capacity", type=int, default=0,
                    help="sparse-frontier ladder capacity (0 = auto)")
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--degree", type=float, default=6.0)
    ap.add_argument("--prob", type=float, default=0.25)
    ap.add_argument("--graph-seed", type=int, default=7)
    ap.add_argument("--colors", type=int, default=64)
    ap.add_argument("--batches", type=int, default=8,
                    help="initial pool size (fused batches)")
    ap.add_argument("--max-batches", type=int, default=64)
    ap.add_argument("--memory-budget-mb", type=float, default=None)
    ap.add_argument("--master-seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--queries", type=int, default=6,
                    help="σ and marginal queries of the mixed flush; with "
                         "--stream-smoke, the delta's deletions and "
                         "insertions each")
    ap.add_argument("--theta-cap", type=int, default=1024,
                    help="θ cap of the smoke's offline run_imm check")
    return ap.parse_args(argv)


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh:
        if args.async_frontend:
            raise NotImplementedError(
                "--async with --mesh is not ported yet: it comes with slice "
                "G2, the mesh front end, whose flushes are broadcast from "
                "rank 0 to the other ranks")
        if args.tier:
            raise SystemExit("--tier serves from one device; drop --mesh")
        if args.sampler_backend not in (None, "data_parallel",
                                        "graph_parallel"):
            raise SystemExit(f"--sampler-backend {args.sampler_backend} "
                             "samples on one device: with --mesh use "
                             "data_parallel or graph_parallel")
        return run_mesh(args, argv)
    if args.sampler_backend in ("data_parallel", "graph_parallel"):
        raise SystemExit(f"--sampler-backend {args.sampler_backend} wants "
                         "--mesh")
    if args.stream_smoke:
        return run_stream(args)
    if args.tier:
        if args.tenants < 2:
            raise SystemExit("--tier wants --tenants >= 2 (tenant0 is the "
                             "quota-starved one)")
        return run_tier(args)
    return run_single(args)


if __name__ == "__main__":
    main()
