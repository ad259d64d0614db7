"""Influence-query serving launcher (PyTorch port of
``repro.launch.serve_influence``, single device).

    python -m repro_torch.launch.serve_influence --smoke
    python -m repro_torch.launch.serve_influence --smoke --sampler-backend kernel
    python -m repro_torch.launch.serve_influence --device cpu --smoke
    python -m repro_torch.launch.serve_influence --smoke --diffusion lt \
        --frontier sparse --sampler-backend kernel

Samples a sketch pool on a synthetic graph, serves one micro-batched mix of
top-k, σ(S) and marginal-gain queries, and with ``--smoke`` also checks the
pool lifecycle: the pool's first batches equal a reference pool built on
the dense CSR backend with the dense frontier (`dense_variant`, so with
``--frontier sparse`` it is also a sparse ≡ dense check), the identical mix
re-served as 100% cache hits, an epoch refresh that invalidates the cache,
and offline ``run_imm`` through a fresh pool equal to the pool-less run
and to the host-loop greedy reference.  ``--device`` defaults to ``cuda``;
``--sampler-backend kernel`` runs every traversal level through the
hand-written CUDA kernels (``fused_expand`` for ``--diffusion ic``,
``lt_select_expand`` for ``lt``), over every tile or, with ``--frontier
sparse``, the level's compacted tile list.
Pool persistence, the async front end and the mesh paths of the reference
launcher come with later slices of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import imm
from repro_torch.graph import csr, generators
from repro_torch.sampling import SamplerSpec
from repro_torch.serve.influence import (MicroBatcher, PoolConfig, QueryEngine,
                                         ResultCache, SketchStore)


# Pool batches the smoke holds against the dense-CSR, dense-frontier pool.
REFERENCE_BATCHES = 2


def build_graph(args):
    """The launcher's synthetic graph, deduped so every backend samples the
    same edge list (the tile layout needs parallel edges merged)."""
    g = generators.powerlaw_cluster(args.n, args.degree, prob=args.prob,
                                    seed=args.graph_seed, device=args.device)
    return csr.dedupe(g)


def build_config(args) -> PoolConfig:
    """The CLI knobs as a `PoolConfig` with its `SamplerSpec`."""
    spec = SamplerSpec(diffusion=args.diffusion,
                       backend=args.sampler_backend, num_colors=args.colors,
                       master_seed=args.master_seed, frontier=args.frontier,
                       frontier_capacity=args.frontier_capacity)
    return PoolConfig(max_batches=args.max_batches,
                      memory_budget_mb=args.memory_budget_mb, spec=spec)


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
    print(f"[smoke] PASS in {time.time() - t0:.1f}s")
    out.update(refresh_slots=slots, refresh_s=refresh_s,
               reflush_s=reflush_s, imm=res_plain,
               imm_pool=res_pool, imm_pool_store=fresh, imm_s=imm_s)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="full lifecycle check on a synthetic graph")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs every "
                         "kernel's plain PyTorch version)")
    ap.add_argument("--diffusion", choices=("ic", "lt"), default="ic",
                    help="diffusion model the pool samples under")
    ap.add_argument("--sampler-backend", default="dense",
                    choices=("dense", "tiled", "kernel"),
                    help="traversal backend: CSR sweep, or the tile "
                         "expansion through the CUDA tile kernels "
                         "(tiled and kernel are the same backend)")
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
    ap.add_argument("--queries", type=int, default=6)
    ap.add_argument("--theta-cap", type=int, default=1024,
                    help="θ cap of the smoke's offline run_imm check")
    return ap.parse_args(argv)


def main(argv=None):
    run_single(parse_args(argv))


if __name__ == "__main__":
    main()
