"""Write the full-size golden values of the reference package for the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --lm-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --q-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --stream-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --unfused-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --mesh-only

Builds the launcher's graph at the size the port's chip smoke serves
(``powerlaw_cluster(65536, 6.0, prob=0.25, seed=7)``, deduped, reversed),
samples batches 0-3 (master_seed 0, 64 colours) with the reference's dense
CSR backend, and records for each batch the sha256 of its visited mask as
little-endian uint32 plus its edge-visit counters, and the top-16 greedy
seeds over the 4-batch pool (``use_kernel=False``: the same function as the
Pallas coverage kernel, without interpret mode at 65,536 rows).  The same
under the LT diffusion (``SamplerSpec(diffusion="lt")``, which normalises
the reversed graph's in-weights) goes under ``"lt"``.  Output:
``tests/data/torch_port_golden.json``, which ``chip_smoke.py`` reads — the
one full-size check of the port on the GPU against the reference.

The ``"lm"`` entry is llama3.2-3b at full width and vocabulary with its
depth cut to 2 layers, in float32, on the weights of the port's
``models/init.py::numpy_params(cfg, seed=0)`` (numpy, no JAX) handed to the
reference in its own tree layout: a prefill of 2 prompts of 64 tokens, then
8 decode steps, each fed the reference's greedy token of the step before.
For the last prefill position and each step it records the logits at 32
seeded vocabulary ids, the max logit, the log-sum-exp, the argmax and the
top-2 gap.  ``--lm-only`` recomputes that entry alone and keeps every other
entry of the file as it is.

The ``"q"`` entry is the quantised-tile traversal at a small size:
``powerlaw_cluster(4096, 6.0, prob=0.25, seed=7)``, deduped, reordered with
``reorder.apply(g, "cluster")``, reversed, its 128×128 tiles quantised
(``fused_expand_q.quantize_probs``), and for batches 0-1 (64 colours,
roots ``rrr.batch_starts``, seeds ``rrr.batch_seeds``, master_seed 0) the
level loop of ``launch/dryrun.py``'s ``graph_q`` cell at one shard,
composed from ``fused_expand_q_ref`` as that cell composes it.  Per batch
it records the level count, the visited popcount and the sha256 of the
visited words.  ``--q-only`` recomputes that entry alone.

The ``"stream"`` entry replays the launcher's ``--stream-smoke`` draws on
the main graph: from ``default_rng(seed + 1)`` the 4 query triples, then
``stream.random_delta(g, rng, 64, 64)``.  For IC and for LT it applies the
delta to the pool's reversed graph as ``stream.plan_refresh`` does (the
reversed delta, LT renormalisation confined to the mutated destinations),
rebinds the dense CSR sampler to the mutated pair as a store does, and
records the mutated reversed graph (edge counts, sha256 of ``src``,
``dst``, ``prob``), the touched rows and row blocks (128 rows), and for
batches 0-3 the sha256, popcount, level count and edge visits.  Under LT
the reference's sampler normalises the mutated graph once more, which is
not a no-op in float32: ``renormalised_edges`` counts the weights it
moves (the port samples the mutated graph as it is, `lt.normalized`).
``--stream-only`` recomputes that entry alone.

The ``"unfused"`` entry is the unfused baseline on the main graph's
batch 0: for each of its 64 colours, ``traversal.run_single_color`` on the
reversed graph from the batch's root with the batch's counter seed, and
its ``levels_run``, the popcount of its mask and its edge visits summed;
the assembled ``(V, W)`` mask's sha256 and the total visits (which must
equal batch 0's fused mask and ``unfused_edge_visits``).  Under
``"sigma"``: ``imm.simulate_influence`` of the first 8 top-16 seeds on the
forward graph, 512 trials, master_seed 77.  ``--unfused-only`` recomputes
that entry alone (reading the seeds from the file).

The ``"mesh"`` entry is the reference's ``graph_parallel`` sampler on a
reduced graph, ``powerlaw_cluster(4096, 6.0, prob=0.25, seed=7)``
deduped, 64 colours, master_seed 0, batches 0-7: IC and LT, meshes
``(data, model)`` = (2, 2) and (1, 3), frontier dense and sparse (auto
capacity).  Per batch it records the sha256 of the visited mask and the
packed words each level moved over the model axis (``last_gather_words``,
trailing zeros dropped).  The reference runs in a subprocess of this
script (``--mesh-worker``) with 4 forced host devices, on meshes whose
axes are ``AxisType.Auto`` (``repro.launch.mesh`` makes ``Explicit``
ones, which its shard_map programs refuse).  ``--mesh-only`` recomputes
that entry alone.  ``mesh_reference_subprocess`` is the same run at any
size and case list (the port's CPU tests call it).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro import stream
from repro.configs import registry
from repro.core import bitmask, imm, lt, rrr, tiles, traversal
from repro.graph import csr, generators, reorder
from repro.kernels import fused_expand_q as feq
from repro.models import decode
from repro.sampling import SamplerSpec, make_sampler
from repro.serve import engine
from repro_torch.configs import registry as port_registry
from repro_torch.models import init as port_init

N, DEGREE, PROB, GRAPH_SEED = 65536, 6.0, 0.25, 7
COLORS, MASTER_SEED, BATCHES, K = 64, 0, 4, 16
LM_ARCH, LM_LAYERS, LM_PARAM_SEED, LM_PROMPT_SEED = "llama3.2-3b", 2, 0, 1
LM_BATCH, LM_PROMPT_LEN, LM_STEPS, LM_IDS = 2, 64, 8, 32
Q_N, Q_ORDER, Q_BATCHES, Q_MAX_LEVELS = 4096, "cluster", 2, 64
STREAM_OPS, STREAM_QUERIES, STREAM_TILE_ROWS = 64, 4, 128
SIGMA_SEEDS, SIGMA_TRIALS, SIGMA_MASTER_SEED = 8, 512, 77
MESH_N, MESH_BATCHES, MESH_DEVICES = 4096, 8, 4
MESH_CASES = [dict(diffusion=d, frontier=f, shape=list(sh))
              for sh in ((2, 2), (1, 3)) for d in ("ic", "lt")
              for f in ("dense", "sparse")]
OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests", "data",
                   "torch_port_golden.json")


def mask_sha256(visited) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(visited), "<u4").tobytes()).hexdigest()


def _logit_summary(logits: np.ndarray, ids: np.ndarray) -> dict:
    """(B, V) float32 logits → the values the port is checked against."""
    lg = logits.astype(np.float64)
    top2 = np.sort(lg, axis=-1)[:, -2:]
    mx = lg.max(-1)
    lse = mx + np.log(np.exp(lg - mx[:, None]).sum(-1))
    return {"logits_at_ids": lg[:, ids].tolist(), "max": mx.tolist(),
            "lse": lse.tolist(), "argmax": lg.argmax(-1).tolist(),
            "top2_gap": (top2[:, 1] - top2[:, 0]).tolist()}


def lm_golden() -> dict:
    """The ``"lm"`` entry (module docstring)."""
    cfg = dataclasses.replace(registry.get(LM_ARCH), num_layers=LM_LAYERS,
                              dtype="float32")
    port_cfg = dataclasses.replace(port_registry.get(LM_ARCH),
                                   num_layers=LM_LAYERS, dtype="float32")
    tree = port_init.numpy_params(port_cfg, LM_PARAM_SEED)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    rng = np.random.default_rng(LM_PROMPT_SEED)
    prompt = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT_LEN))
    ids = np.sort(rng.choice(cfg.vocab_size, LM_IDS, replace=False))
    last, caches, _ = engine.prefill(params, cfg,
                                     {"tokens": jnp.asarray(prompt)},
                                     LM_PROMPT_LEN + LM_STEPS)
    logits = np.asarray(last[:, -1], np.float32)
    out = {"arch": LM_ARCH, "num_layers": LM_LAYERS, "dtype": "float32",
           "param_seed": LM_PARAM_SEED, "prompt_seed": LM_PROMPT_SEED,
           "prompt": prompt.tolist(), "vocab_ids": ids.tolist(),
           "prefill": _logit_summary(logits, ids), "decode": []}
    step = jax.jit(lambda p, c, t, n: decode.decode_step(p, cfg, c, t, n))
    for i in range(LM_STEPS):
        tok = logits.argmax(-1)[:, None]
        lg, caches = step(params, caches, jnp.asarray(tok),
                          jnp.int32(LM_PROMPT_LEN + i))
        logits = np.asarray(lg[:, -1], np.float32)
        out["decode"].append({"cur_len": LM_PROMPT_LEN + i,
                              "tokens": tok[:, 0].tolist(),
                              **_logit_summary(logits, ids)})
    return out


def q_golden() -> dict:
    """The ``"q"`` entry (module docstring)."""
    g = csr.dedupe(generators.powerlaw_cluster(Q_N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    g_rev = csr.transpose(reorder.apply(g, Q_ORDER)[0])
    tg = tiles.from_graph(g_rev)
    q8 = feq.quantize_probs(tg.prob)

    @jax.jit
    def graph_q(starts, seed):
        # launch/dryrun.py:260-281 at one shard (all_gather is the identity)
        fr0 = tiles.pad_mask_rows(
            traversal.init_frontier(Q_N, COLORS, starts), tg.padded_vertices)

        def cond(c):
            fr, _, lvl = c
            return jnp.logical_and(bitmask.any_set(fr), lvl < Q_MAX_LEVELS)

        def step(c):
            fr, vis, lvl = c
            vis = vis | fr
            nf = feq.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst, fr, vis,
                                        seed, lvl.astype(jnp.uint32))
            return nf, vis, lvl + 1

        fr, vis, lvl = jax.lax.while_loop(
            cond, step, (fr0, jnp.zeros_like(fr0), jnp.int32(0)))
        return vis | fr, lvl

    batches = []
    for b in range(Q_BATCHES):
        starts = rrr.batch_starts(Q_N, COLORS, MASTER_SEED, b)
        seed = jnp.uint32(rrr.batch_seeds(MASTER_SEED, [b])[0])
        vis, levels = graph_q(jnp.asarray(starts), seed)
        words = np.asarray(vis)[:Q_N]
        batches.append({"batch_index": b, "levels": int(levels),
                        "visited_bits": int(np.unpackbits(
                            words.view(np.uint8)).sum()),
                        "visited_sha256": mask_sha256(words)})
    return {"graph": {"generator": "powerlaw_cluster", "n": Q_N,
                      "avg_deg": DEGREE, "prob": PROB, "seed": GRAPH_SEED,
                      "dedupe": True, "order": Q_ORDER,
                      "num_edges": g_rev.num_edges, "tile_size": tiles.TILE,
                      "num_tiles": tg.num_tiles},
            "num_colors": COLORS, "master_seed": MASTER_SEED,
            "max_levels": Q_MAX_LEVELS, "batches": batches}


def _graph_digest(g) -> dict:
    """Edge counts and the sha256 of the padded edge arrays."""
    out = {"num_edges": int(g.num_edges), "padded_edges": int(g.padded_edges)}
    for name, dtype in (("src", "<i4"), ("dst", "<i4"), ("prob", "<f4")):
        out[f"{name}_sha256"] = hashlib.sha256(np.ascontiguousarray(
            np.asarray(getattr(g, name)), dtype).tobytes()).hexdigest()
    return out


@jax.jit
def _lt_levels(g_rev, cb, starts, seed):
    """Levels of ``lt.lt_traversal_program``'s loop (the same loop, with
    the level count returned)."""
    sel = lt.selection_mask_from_cb(g_rev, cb, COLORS, seed)
    fr0 = traversal.init_frontier(g_rev.num_vertices, COLORS, starts)

    def cond(c):
        fr, _, lvl = c
        return jnp.logical_and(bitmask.any_set(fr), lvl < 64)

    def body(c):
        fr, vis, lvl = c
        vis = vis | fr
        contrib = fr[g_rev.src] & sel & ~vis[g_rev.dst]
        nf = traversal._scatter_or(jnp.zeros_like(vis), g_rev.dst,
                                   contrib) & ~vis
        return nf, vis, lvl + 1

    return jax.lax.while_loop(cond, body,
                              (fr0, jnp.zeros_like(fr0), jnp.int32(0)))[2]


def stream_golden() -> dict:
    """The ``"stream"`` entry (module docstring)."""
    g = csr.dedupe(generators.powerlaw_cluster(N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    rng = np.random.default_rng(GRAPH_SEED + 1)
    queries = [rng.integers(0, N, 3).tolist() for _ in range(STREAM_QUERIES)]
    delta = stream.random_delta(g, rng, num_deletes=STREAM_OPS,
                                num_inserts=STREAM_OPS)
    g2, _ = stream.apply_delta(g, delta)
    out = {"ops": STREAM_OPS, "queries": queries,
           "delta_sha256": hashlib.sha256(b"".join(
               np.ascontiguousarray(a).tobytes() for a in
               (delta.src, delta.dst, delta.weight, delta.insert))
           ).hexdigest(),
           "num_inserts": delta.num_inserts,
           "num_deletes": delta.num_deletes,
           "tile_rows": STREAM_TILE_ROWS}
    for diffusion in ("ic", "lt"):
        spec = SamplerSpec(diffusion=diffusion, backend="dense",
                           num_colors=COLORS, master_seed=MASTER_SEED,
                           tile_size=STREAM_TILE_ROWS)
        sampler = make_sampler(g, spec)
        g_rev2, applied = stream.apply_delta(
            sampler.g_rev, delta.reversed(), lt_normalized=diffusion == "lt")
        blocks = stream.touched_row_blocks(applied.touched_rows,
                                           STREAM_TILE_ROWS)
        rebound = sampler.rebind(g2, g_rev2, blocks)
        cb = jnp.asarray(lt.selection_cum_before(rebound.g_rev))
        batches = []
        for b in rebound.sample_many(range(BATCHES)):
            starts = jnp.asarray(b.roots)
            seed = jnp.uint32(rrr.batch_seed(MASTER_SEED, b.batch_index))
            levels = (_lt_levels(rebound.g_rev, cb, starts, seed)
                      if diffusion == "lt" else traversal.run_fused(
                          rebound.g_rev, starts, COLORS,
                          seed).stats.levels_run)
            batches.append({
                "batch_index": b.batch_index,
                "visited_sha256": mask_sha256(b.visited),
                "visited_bits": int(np.unpackbits(
                    np.asarray(b.visited).view(np.uint8)).sum()),
                "levels": int(levels),
                "fused_edge_visits": b.fused_edge_visits,
                "unfused_edge_visits": b.unfused_edge_visits})
        out[diffusion] = {
            "g_rev": _graph_digest(g_rev2),
            "renormalised_edges": int(np.count_nonzero(
                np.asarray(rebound.g_rev.prob) != np.asarray(g_rev2.prob))),
            "touched_rows": int(len(applied.touched_rows)),
            "touched_row_blocks": blocks.tolist(),
            "batches": batches}
    return out


def unfused_golden(top_seeds) -> dict:
    """The ``"unfused"`` entry (module docstring)."""
    g = csr.dedupe(generators.powerlaw_cluster(N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    g_rev = csr.transpose(g)
    starts = np.asarray(rrr.batch_starts(N, COLORS, MASTER_SEED, 0))
    seed = rrr.batch_seed(MASTER_SEED, 0)
    visited = np.zeros((N, bitmask.num_words(COLORS)), np.uint32)
    colors = []
    for c in range(COLORS):
        res = traversal.run_single_color(g_rev, int(starts[c]), c, seed)
        words = np.asarray(res.visited[:, 0])
        visited[:, c // 32] |= words
        colors.append({
            "color": c, "levels_run": int(res.stats.levels_run),
            "popcount": int(np.unpackbits(words.view(np.uint8)).sum()),
            "edge_visits": int(np.asarray(res.stats.fused_edge_visits,
                                          np.int64).sum())})
    seeds = [int(s) for s in top_seeds[:SIGMA_SEEDS]]
    sigma = imm.simulate_influence(g, np.asarray(seeds),
                                   num_trials=SIGMA_TRIALS,
                                   master_seed=SIGMA_MASTER_SEED)
    return {"batch_index": 0, "visited_sha256": mask_sha256(visited),
            "total_edge_visits": sum(c["edge_visits"] for c in colors),
            "colors": colors,
            "sigma": {"seeds": seeds, "num_trials": SIGMA_TRIALS,
                      "master_seed": SIGMA_MASTER_SEED, "value": sigma}}


def mesh_reference(job: dict) -> list:
    """The reference's ``graph_parallel`` batches of ``job`` (graph size
    and knobs, ``cases`` of diffusion, frontier, mesh shape and capacity)
    in a process with enough forced host devices: per case and batch, the
    mask's sha256 and the per-level exchange words."""
    from jax.sharding import AxisType

    g = csr.dedupe(generators.powerlaw_cluster(
        job["n"], job.get("degree", DEGREE), prob=job.get("prob", PROB),
        seed=job.get("seed", GRAPH_SEED)))
    out = []
    for case in job["cases"]:
        shape = tuple(case["shape"])
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        spec = SamplerSpec(diffusion=case["diffusion"],
                           backend="graph_parallel",
                           num_colors=job.get("colors", COLORS),
                           master_seed=job.get("master_seed", MASTER_SEED),
                           frontier=case["frontier"],
                           frontier_capacity=case.get("capacity", 0),
                           tile_size=job.get("tile_size", tiles.TILE))
        sampler = make_sampler(g, spec, mesh=mesh)
        batches = sampler.sample_many(range(job["batches"]))
        words = np.asarray(sampler.last_gather_words)
        out.append(dict(case, batches=[
            {"batch_index": b.batch_index,
             "visited_sha256": mask_sha256(b.visited),
             "gather_words": [int(x) for x in np.trim_zeros(words[i], "b")]}
            for i, b in enumerate(batches)]))
    return out


def mesh_reference_subprocess(job: dict, devices: int = MESH_DEVICES,
                              timeout: float = 900.0) -> list:
    """`mesh_reference` of ``job`` in a fresh process with ``devices``
    forced host devices (this process's device count cannot change)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--mesh-worker", json.dumps(job)], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"reference mesh run failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def mesh_golden() -> dict:
    job = dict(n=MESH_N, batches=MESH_BATCHES, cases=MESH_CASES)
    return {"graph": {"generator": "powerlaw_cluster", "n": MESH_N,
                      "avg_deg": DEGREE, "prob": PROB, "seed": GRAPH_SEED,
                      "dedupe": True},
            "num_colors": COLORS, "master_seed": MASTER_SEED,
            "tile_size": tiles.TILE, "devices": MESH_DEVICES,
            "cases": mesh_reference_subprocess(job)}


def main() -> None:
    ap = argparse.ArgumentParser()
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--lm-only", action="store_true",
                      help="recompute the \"lm\" entry alone")
    only.add_argument("--q-only", action="store_true",
                      help="recompute the \"q\" entry alone")
    only.add_argument("--stream-only", action="store_true",
                      help="recompute the \"stream\" entry alone")
    only.add_argument("--unfused-only", action="store_true",
                      help="recompute the \"unfused\" entry alone")
    only.add_argument("--mesh-only", action="store_true",
                      help="recompute the \"mesh\" entry alone")
    only.add_argument("--mesh-worker", metavar="JOB_JSON",
                      help="print mesh_reference(JOB) as JSON (run by "
                           "mesh_reference_subprocess)")
    args = ap.parse_args()
    if args.mesh_worker:
        print(json.dumps(mesh_reference(json.loads(args.mesh_worker))))
        return
    t0 = time.time()
    entries = {"lm": lm_golden, "q": q_golden, "stream": stream_golden,
               "unfused": lambda: unfused_golden(golden["top_k"]["seeds"]),
               "mesh": mesh_golden}
    key = next((k for k in entries if getattr(args, f"{k}_only")), None)
    if key is not None:
        with open(OUT) as f:
            golden = json.load(f)
        golden[key] = entries[key]()
        _write(golden)
        print(f"wrote the {key} entry of {os.path.normpath(OUT)} in "
              f"{time.time() - t0:.1f}s")
        return
    g = csr.dedupe(generators.powerlaw_cluster(N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    g_rev = csr.transpose(g)
    _, num_tiles = tiles.edge_slot_map(g_rev)
    pools = {}
    for diffusion in ("ic", "lt"):
        sampler = make_sampler(g, SamplerSpec(
            diffusion=diffusion, backend="dense", num_colors=COLORS,
            master_seed=MASTER_SEED), g_rev=g_rev)
        batches = sampler.sample_many(range(BATCHES))
        stack = np.stack([np.asarray(b.visited) for b in batches])
        pools[diffusion] = (batches, *imm.greedy_max_cover(
            stack, K, COLORS, use_kernel=False))
    batches, seeds, cov = pools["ic"]
    lt_batches, lt_seeds, lt_cov = pools["lt"]
    golden = {
        "graph": {"generator": "powerlaw_cluster", "n": N, "avg_deg": DEGREE,
                  "prob": PROB, "seed": GRAPH_SEED, "dedupe": True,
                  "num_edges": g.num_edges, "tile_size": tiles.TILE,
                  "num_tiles": int(num_tiles)},
        "num_colors": COLORS,
        "master_seed": MASTER_SEED,
        "batches": [
            {"batch_index": b.batch_index,
             "visited_sha256": mask_sha256(b.visited),
             "roots_sha256": hashlib.sha256(
                 np.ascontiguousarray(b.roots, "<i4").tobytes()).hexdigest(),
             "visited_bits": int(np.unpackbits(
                 np.asarray(b.visited).view(np.uint8)).sum()),
             "fused_edge_visits": b.fused_edge_visits,
             "unfused_edge_visits": b.unfused_edge_visits}
            for b in batches],
        "top_k": {"k": K, "batches": BATCHES, "seeds": seeds.tolist(),
                  "coverage": cov},
        "lt": {
            "batches": [
                {"batch_index": b.batch_index,
                 "visited_sha256": mask_sha256(b.visited),
                 "visited_bits": int(np.unpackbits(
                     np.asarray(b.visited).view(np.uint8)).sum())}
                for b in lt_batches],
            "top_k": {"k": K, "batches": BATCHES,
                      "seeds": lt_seeds.tolist(), "coverage": lt_cov},
        },
    }
    golden["lm"] = lm_golden()
    golden["q"] = q_golden()
    golden["stream"] = stream_golden()
    golden["unfused"] = unfused_golden(seeds.tolist())
    golden["mesh"] = mesh_golden()
    _write(golden)
    print(f"wrote {os.path.normpath(OUT)} in {time.time() - t0:.1f}s")


def _write(golden: dict) -> None:
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
