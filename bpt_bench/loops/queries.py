"""Query serving: a closed loop of clients asking σ(S) and Δσ(v | X) of a
held pool.

Set-up builds the configuration's graph from the seed, the program's pool
of ``pool_batches`` batches and its stacked masks, and the query front (a
``QueryEngine`` behind a ``MicroBatcher`` with a ``ResultCache``), then
warms up with rounds of the loop on queries of their own until the result
cache holds ``cache_capacity`` entries, as a front in steady state does:
until then every marginal flush keeps a fresh 5 MB array on the host, and
the first seconds' flushes run slower.

``clients`` gives how many clients ask each kind (``sigma``,
``marginal``).  Each client has one query outstanding: all of them submit,
one ``flush`` answers them, and each sends its next when its answer is
back.  A client's sets come in blocks that hold each size of
``set_size`` (inclusive) once, in an order drawn from the seed, with
vertices uniform, drawn from the seed: every seed asks the same sizes.
A query's latency runs from its submit to the end of the flush that
answers it.  The window runs rounds until ``--seconds`` have passed; the
last one runs to its end.

Other parameters: ``query_slots``, ``max_seeds`` and ``cache_capacity``
(the front), ``check_answers`` (answers sampled from the seed and
recomputed), ``check_batches`` (rows of the pool's stacked masks sampled
from the seed and recomputed), ``trace_from`` and ``trace_seconds`` (the
profiled slice, as a share and seconds of the window).
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from bpt_bench import check, program, work
from bpt_bench.reference import answers, graphgen
from repro_torch.serve.influence import FlushError

SIGMA, MARGINAL = "sigma", "marginal"
_WINDOW_STREAM, _WARM_STREAM = 11, 12


@dataclasses.dataclass
class State:
    config: dict
    traffic: dict
    seed: int
    devices: list
    edges: graphgen.Edges
    store: object
    batcher: object
    stack: torch.Tensor | None = None
    pool_sample: list = dataclasses.field(default_factory=list)
    kept: check.Reservoir | None = None
    missing: int = 0
    queries: int = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clients(traffic: dict) -> list[str]:
    """The kind each client asks, σ clients first."""
    c = traffic["clients"]
    return [SIGMA] * int(c[SIGMA]) + [MARGINAL] * int(c[MARGINAL])


def client_sets(traffic: dict, seed: int, num_vertices: int, stream: int,
                client: int):
    """The vertex sets client ``client`` asks about, one after another."""
    lo, hi = traffic["set_size"]
    sizes = np.arange(int(lo), int(hi) + 1)
    r = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                               stream, client])
    while True:
        for k in r.permutation(sizes):
            yield r.integers(0, num_vertices, int(k)).tolist()


def setup(config: dict, traffic: dict, seed: int, devices: list) -> State:
    device = devices[0]
    edges = graphgen.deployment_graph(config, seed)
    pool = int(traffic["pool_batches"])
    store = program.store(edges, config, seed, pool, device)
    store.visited_stack()
    batcher = program.query_front(store, int(traffic["query_slots"]),
                                  int(traffic["max_seeds"]),
                                  int(traffic["cache_capacity"]))
    st = State(config, traffic, seed, [device], edges, store, batcher)
    cache = batcher.cache
    _serve(st, lambda t, rounds: rounds == 0 or len(cache) < cache.capacity,
           None, _WARM_STREAM)
    _sync(device)
    st.missing = 0
    return st


def window(st: State, seconds: float, tracer) -> dict:
    rec = _serve(st, lambda t, rounds: t < seconds, tracer,
                 _WINDOW_STREAM, seconds)
    q = len(rec["flush_ms"]) // 10
    if q:
        parts = [np.percentile(rec["flush_ms"][i * q:(i + 1) * q], 95)
                 for i in range(10)]
        print("bpt_bench: flush p95 ms by tenth of the window: "
              + " ".join(f"{p:.3f}" for p in parts), file=sys.stderr)
    return rec


def _serve(st: State, more, tracer, stream: int,
           seconds: float = 0.0) -> dict:
    """Rounds of the closed loop while ``more(elapsed s, rounds done)``;
    ``seconds`` places the profiled slice."""
    tr = st.traffic
    kinds = clients(tr)
    sets = [client_sets(tr, st.seed, st.edges.num_vertices, stream, c)
            for c in range(len(kinds))]
    st.kept = check.Reservoir(int(tr["check_answers"]), st.seed)
    batcher = st.batcher
    submit = {SIGMA: batcher.submit_sigma, MARGINAL: batcher.submit_marginal}
    latency, flush_ms = [], []
    trace_at = float(tr["trace_from"]) * seconds
    trace_len = float(tr["trace_seconds"])
    slice_from = None                # window time the slice began at
    asked = 0
    d0 = batcher.dispatches
    t0 = time.perf_counter()
    t = t0
    while more(t - t0, len(flush_ms)):
        tickets = []
        for c, kind in enumerate(kinds):
            q = next(sets[c])
            tickets.append((kind, q, submit[kind](q), time.perf_counter()))
        asked += len(tickets)
        if tracer is not None and slice_from is None and t - t0 >= trace_at:
            tracer.start()
            slice_from = t - t0
        a = time.perf_counter()
        try:
            with torch.profiler.record_function("flush"):
                results = batcher.flush()
        except FlushError as e:
            results = e.partial
        t = time.perf_counter()
        flush_ms.append((t - a) * 1e3)
        if tracer is not None and tracer.active \
                and t - t0 - slice_from >= trace_len:
            tracer.stop()
        for kind, q, ticket, ts in tickets:
            if ticket not in results:
                st.missing += 1
                continue
            latency.append((t - ts) * 1e3)
            st.kept.offer((kind, q, results[ticket]))
    if tracer is not None and tracer.active:
        tracer.stop()
    st.queries = asked
    return {"t0": t0, "window_s": t - t0, "queries": asked,
            "answered": len(latency), "latency_ms": latency,
            "flush_ms": flush_ms, "flushes": len(flush_ms),
            "dispatches": batcher.dispatches - d0,
            "pool": tuple(st.store.visited_stack().shape),
            "query_slots": int(tr["query_slots"])}


def layer_record(st: State, rec: dict) -> None:
    """The work of one ``cover_counts`` launch over the pool."""
    b, v, w = rec["pool"]
    ops, nbytes = work.cover_counts(b, v, w, rec["query_slots"])
    rec["work"] = {"cover_counts_launch": {"ops": ops, "bytes": nbytes}}


def release(st: State) -> None:
    """Drop the program's layout and front; keep the pool's stacked masks
    (what the answers were read from) and, for rows drawn from the seed,
    their batch index and roots."""
    pick = np.random.default_rng(
        [int(st.seed) & 0xFFFFFFFF, int(st.seed) >> 32, 13])
    batches = st.store.batches
    st.stack = st.store.visited_stack()
    idx = pick.choice(len(batches), int(st.traffic["check_batches"]),
                      replace=False)
    st.pool_sample = [(batches[i].batch_index, batches[i].roots,
                       st.stack[i]) for i in sorted(idx)]
    st.store = st.batcher = None


def verify(st: State, rec: dict) -> tuple[dict, int, int]:
    """(checks, attempted, failed): sampled rows of the stacked pool
    against the plain sampler; sampled answers against plain answers over
    that stack; every query asked answered."""
    found = check.batches_against_reference(
        st.pool_sample, st.edges, st.config, st.seed,
        int(st.config["max_levels"]), st.devices[0])
    pool = st.stack
    C = int(st.config["num_colors"])
    nv, theta = pool.shape[1], pool.shape[0] * C
    gap = 0.0
    for kind, vertices, got in st.kept.items:
        if kind == SIGMA:
            want = answers.estimate(answers.sigma_count(pool, vertices, C),
                                    nv, theta)
            gap = max(gap, abs(float(got) - want))
        else:
            want = answers.estimate(
                answers.marginal_counts(pool, vertices, C), nv, theta)
            gap = max(gap, float(np.max(np.abs(np.asarray(got) - want))))
    checks = {
        "pool_bits_off": {"value": found["mask_bits_off"], "limit": 0},
        "roots_off": {"value": found["roots_off"], "limit": 0},
        "answer_gap": {"value": gap, "limit": 0},
        "answers_missing": {"value": st.missing, "limit": 0},
        "answers_unchecked": {
            "value": min(st.kept.k, rec["answered"]) - len(st.kept.items),
            "limit": 0},
    }
    return checks, st.queries, st.missing
