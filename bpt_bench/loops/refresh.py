"""Pool building: a closed loop of ``SketchStore.refresh`` calls.

Set-up builds the configuration's graph from the seed, the program's
pool of ``pool_batches`` batches (layout, slot list, kernels) and makes
one ``refresh`` as the warm-up.  The window calls ``refresh(fraction)``
back to back, each ending in a synchronise, until ``--seconds`` have
passed; the last call runs to its end.  Each call must bring
``ceil(fraction · pool_batches)`` batches at the next batch indices.

Traffic parameters: ``pool_batches``, ``fraction``, ``check_batches``
(window batches sampled from the seed and compared with the plain
sampler), ``trace_from_call`` and ``trace_calls`` (the profiled slice of
a ``--trace 1`` run).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from bpt_bench import check, program, work
from bpt_bench.reference import graphgen

KERNEL = "fused_expand"


@dataclasses.dataclass
class State:
    config: dict
    traffic: dict
    seed: int
    devices: list
    edges: graphgen.Edges
    store: object
    per_call: int
    sample: object = None            # the sampler's own ``sample``
    in_slice: bool = False
    slice_batches: list = dataclasses.field(default_factory=list)
    kept: check.Reservoir | None = None
    missing: int = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config: dict, traffic: dict, seed: int, devices: list) -> State:
    device = devices[0]
    edges = graphgen.deployment_graph(config, seed)
    pool = int(traffic["pool_batches"])
    store = program.store(edges, config, seed, pool, device)
    st = State(config, traffic, seed, [device], edges, store,
               per_call=math.ceil(float(traffic["fraction"]) * pool))
    store.refresh(float(traffic["fraction"]))
    _sync(device)
    return st


def _wrap_sample(st: State) -> None:
    """Wrap the sampler's ``sample`` (this run only): a profiler span
    ``TiledSampler.sample``, and inside the slice each batch's levels and
    mask for the work counter."""
    sampler = st.store.sampler
    st.sample = sampler.sample

    def sample(batch_index):
        with torch.profiler.record_function("TiledSampler.sample"):
            out = st.sample(batch_index)
        if st.in_slice:
            st.slice_batches.append((sampler.last_levels, out.visited))
        return out

    sampler.sample = sample


def window(st: State, seconds: float, tracer) -> dict:
    store, frac = st.store, float(st.traffic["fraction"])
    st.kept = check.Reservoir(int(st.traffic["check_batches"]), st.seed)
    first = int(st.traffic["trace_from_call"])
    last = first + int(st.traffic["trace_calls"]) - 1
    if tracer is not None:
        _wrap_sample(st)
    expect = store.next_batch_index
    calls = []
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while time.perf_counter() < end:
        if tracer is not None and i == first:
            tracer.start()
            st.in_slice = True
        n0 = program.launches(KERNEL)
        a = time.perf_counter()
        with torch.profiler.record_function("refresh"):
            slots = store.refresh(frac)
            _sync(st.devices[0])
        b = time.perf_counter()
        if st.in_slice and i == last:
            tracer.stop()
            st.in_slice = False
        got = {store.batches[s].batch_index: store.batches[s] for s in slots}
        for index in range(expect, expect + st.per_call):
            batch = got.get(index)
            if batch is None:
                st.missing += 1
            else:
                st.kept.offer(batch)
        expect += st.per_call
        calls.append((a, b, program.launches(KERNEL) - n0, i >= first
                      and i <= last and tracer is not None))
        i += 1
    if st.in_slice:
        tracer.stop()
        st.in_slice = False
    made = len(calls) * st.per_call - st.missing
    return {"t0": t0, "window_s": calls[-1][1] - t0, "calls": len(calls),
            "batches": made,
            "sets": made * int(st.config["num_colors"]),
            "levels": sum(c[2] for c in calls),
            "untraced_calls": [(b - a, n) for a, b, n, traced in calls
                               if not traced]}


def layer_record(st: State, rec: dict) -> None:
    """The traced slice's work: its batches' levels, live draws and
    bytes, counted from the inputs (`bpt_bench.work`).  A batch that
    reached the level cap adds its bytes and no draws: its mask holds the
    last frontier, whose colours were never drawn from, so the count
    stays below the work done."""
    if not st.slice_batches:
        return
    e = st.edges
    live = e.prob > 0
    out_degree = torch.from_numpy(
        np.bincount(e.dst[live], minlength=e.num_vertices))
    tiles = len(np.unique((e.src.astype(np.int64) // 128)
                          * (e.num_vertices // 128 + 1) + e.dst // 128))
    words = st.slice_batches[0][1].shape[1]
    rows = -(-e.num_vertices // 128) * 128
    per_level = work.expand_level_bytes(int(live.sum()), tiles, rows, words)
    max_levels = int(st.config["max_levels"])
    ops = nbytes = 0.0
    levels = capped = 0
    for lv, visited in st.slice_batches:
        if lv < max_levels:      # a capped mask holds an undrawn frontier
            ops += work.expand_batch_ops(visited, out_degree)
        nbytes += lv * per_level
        levels += lv
        capped += lv >= max_levels
    rec["work"] = {"ops": ops, "bytes": nbytes, "levels": levels,
                   "batches": len(st.slice_batches), "capped": capped}


def release(st: State) -> None:
    """Drop the program's pool, graph and layout; keep the sample."""
    if st.sample is not None:
        st.store.sampler.sample = st.sample
    st.store = None
    st.slice_batches = []


def verify(st: State, rec: dict) -> tuple[dict, int, int]:
    """(checks, attempted, failed): the sampled window batches against
    the plain sampler, and every batch the window owed."""
    kept = sorted(st.kept.items, key=lambda b: b.batch_index)
    found = check.batches_against_reference(
        [(b.batch_index, b.roots, b.visited) for b in kept], st.edges,
        st.config, st.seed, int(st.config["max_levels"]), st.devices[0])
    want = min(st.kept.k, st.kept.seen + st.missing)
    checks = {
        "mask_bits_off": {"value": found["mask_bits_off"], "limit": 0},
        "roots_off": {"value": found["roots_off"], "limit": 0},
        "batches_missing": {"value": st.missing, "limit": 0},
        "batches_unchecked": {"value": want - len(kept), "limit": 0},
    }
    attempted = rec["calls"] * st.per_call
    return checks, attempted, st.missing
