"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (the kernels are built for ``sm_90a``) and the
CUDA toolkit's ``nvcc``; it exits non-zero, printing no result, anywhere
else.  Phases, each of which raises on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the seven kernel sources of ``src/repro_torch/csrc``, compiled
   in parallel, with each source's registers and spills from ``ptxas``
   (and each ``cover_counts`` instantiation's registers);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   exact equality — ``fused_expand`` and ``lt_select_expand`` on a reduced
   graph (empty frontier, destination blocks no tile reaches,
   ``pad_tiles_to`` padding tiles, 32/64/96/256 colours) over every tile
   and over compacted tile lists (empty, one source block, full),
   ``fused_expand_q`` on the same graph's quantised stack (32/64/128/256
   colours, the same lists); the three slot-list kernels also on a graph
   whose hub rows take 300 in-edges each, against their tile-form plain
   versions; each slot list (IC, quantised, LT) holding exactly the slots
   that pass its value test and equal to the list read back from its
   stack; ``cover_counts`` and ``cover_counts_multi`` (8 masks) at the
   full pool shape and at W 1, 3, 5 and 8;
4. IC main path at full size: the serving launcher's ``run_single`` on the
   kernel backend — powerlaw_cluster(65,536, 6.0, p=0.25, seed 7), 64
   colours, a 64-batch pool (4,096 RRR sets), one mixed micro-batched flush
   (top-16, 6 σ, 6 marginal), the same flush as 100% cache hits, a 25%
   refresh, the pool saved and restored (identical stack, counters and
   top-16; the snapshot's MiB and the save and restore seconds), and
   offline ``run_imm`` (ε 0.5, θ ≤ 4,096) through a fresh pool and without
   one, both equal to the host-loop greedy.  The launch counters
   are zeroed just before and read just after; ``fused_expand`` and
   ``cover_counts`` must have run, and ``cover_counts_multi`` once for each
   marginal dispatch (one for all its query slots);
5. IC golden: batches 0-3 on the kernel backend (dense grid and compacted
   grid), 0-1 on the dense CSR backend, bit for bit against
   ``tests/data/torch_port_golden.json`` (made by
   ``scripts/make_torch_golden.py`` from the JAX reference), plus the
   top-16 seeds over that 4-batch pool;
6. IC timing: the slot list's entries and bytes, and the time to read it
   back from the stacks (equal to the layout's); every level of batch 0
   through the kernel's CUDA wrapper on the dense grid and on the
   compacted grid (device time per launch, launches replayed from a CUDA
   graph), the compaction, and the plain version (equal at every level);
   ``cover_counts`` at the pool's shape as device time, cold (a CUDA graph
   of 10 L2 flushes and launches less one of the 10 flushes) and warm,
   beside the events-around-one-eager-call figure of earlier runs, the
   8-mask form against 8 one-mask launches; each beside its bound on this
   card;
6a. the serving tier, after the IC phase's release: the launcher's
   ``run_tier --smoke --autoscale`` (3 tenants, tenant0 starved, over 2
   replicas of a 64-batch pool on the kernel backend): sheds carry a
   retry-after, every in-quota answer equals a direct ``QueryEngine`` on a
   clone, a refresh of one replica never yields a mixed-epoch gather, the
   replicas re-converge bit for bit, and an autoscale step keeps them
   consistent; p50 and p99 query latency from the tier's histogram;
   counters as in 4, ``cover_counts`` must have run;
6b. an IC streaming delta: the launcher's ``run_stream`` (``--queries 64``:
   64 deletions and 64 insertions) through the tier on the kernel backend —
   the incremental pool equals ``cold_rebuild_batches`` word for word, the
   replicas agree, a pre/post-delta gather is refused, a starved tenant's
   second delta is shed — and the delta, the mutated reversed graph, the
   touched row blocks and slots 0-3 (words, levels, the dense CSR
   sampler's edge visits) against the golden file's ``"stream"`` entry;
   it prints the touched row blocks, the dirty slots of 64, ``apply_plan``
   split into the rebind (layout and slot-list rebuild) and the
   resampling, and a cold rebuild of all 64 slots; ``fused_expand`` must
   have run.  Then ``SamplingDriver`` on the mutated pair (4 workers, 20%
   injected failures, 16 batches) equal to the store's slots 0-15, with
   ``fused_expand`` launched by its workers;
7. LT main path at full size, after the IC tile stacks are released: the
   same launcher run with ``--diffusion lt --frontier sparse`` (the
   ``lt_select_expand`` kernel on the compacted tile list's slot list);
   counters as in 4, ``lt_select_expand`` and ``cover_counts`` must have
   run, ``cover_counts_multi`` as in 4, and the pool saved and restored as
   in 4;
8. LT golden: batches 0-3 on the kernel backend, dense and compacted grid,
   0-1 on the dense CSR backend, and the top-16 seeds, against the file;
9. LT timing: as 6 (the LT slot list, both grids), with the plain version
   on the compacted list;
9a. an LT streaming delta, after the LT phase's release: as 6b with
   ``--diffusion lt --frontier sparse`` (``lt_select_expand`` must have
   run; the renormalised in-edges count among the touched rows), without
   the driver;
9b. the unfused baseline and forward σ(S), after the LT stream phase's
    release, at the main configuration (65,536 vertices, reversed, 64
    colours, batch 0's roots and seed): (a) ``run_unfused`` (64
    single-colour CSR runs) equals ``run_fused``'s mask and the golden
    batch 0 word for word, its total edge visits the golden
    ``unfused_edge_visits``, and each colour's levels, popcount and visits
    the golden ``"unfused"`` entry (``make_torch_golden.py
    --unfused-only``); these paths and (b) launch no kernel; (b)
    ``simulate_influence`` of the first 8 golden top-16 seeds, 512 trials,
    equals the golden σ exactly; (c) that forward σ lies within 4 standard
    errors (from the samples) of n × ``coverage_of`` on a fresh
    ``sample_collection`` of 4,096 RRR sets (kernel backend, master_seed
    4,242), and exceeds the forward σ of 8 random vertices; (d) batch 0 on
    the host clock, 3 runs in turns: ``run_fused`` (CSR), ``run_unfused``
    (CSR) and the kernel backend, with the unfused/fused ratio, the edge
    visits and their savings, the levels and the mean occupancy;
9c. the paper's Fig. 7/8 grid at a Table-1 size: ``powerlaw_cluster`` at
    web-Google's vertices and average degree (875,713, 11.66, seed 2),
    reversed, re-weighted to a constant p ∈ {0.05, 0.1, 0.2}, colours ∈
    {8, 32, 64} from ``random_starts(0, ...)``; at every point
    ``run_unfused`` ≡ ``run_fused`` word for word and in total visits
    (Theorem 1's coupling, exact), the fused time as the median of 3 runs,
    the unfused one of as many runs as fit in 4 s (at most 3), the
    speedup, the visit ratio, levels, occupancy and peak memory.  CSR
    against CSR, as in the reference: no tile layout at this size;
9d. the mesh paths on ranks that share the card (`launch.accel.spawn`;
    each rank's program in ``repro_torch/launch/mesh_smoke.py``), at the
    main configuration: (a) ``graph_parallel`` IC on a 2×2 (data × model)
    mesh over gloo — batches 0-3 against the golden sha256s, the top-16
    of their pool through ``DistributedQueryEngine``, a 64-batch pool
    timed on the dense exchange leg and on the sparse one (auto capacity)
    with equal masks and the per-level ``gather_words`` of each, every
    level of batch 0 on each rank's slot list through ``fused_expand``
    against its plain version, each rank's launches of ``fused_expand``
    and ``cover_counts`` (counters zeroed just before, read just after,
    both > 0), and on each rank's block of the 64-batch pool
    ``cover_counts`` / ``cover_counts_multi`` against their plain versions
    on the engine's masks (pad slots zero); (f) on the same 2×2 mesh, the
    async front end over (a)'s 64-batch pool: rank 0 runs
    ``AsyncFrontEnd`` over a ``MeshLeader`` (deadline 0.05 s, 8 flush
    slots, a background refresh every 1.5 s) and serves a lone σ, 24
    threaded σ clients, a top-16 and a marginal query, then closes, while
    the other ranks ``follow``; every answer equals the engine's own,
    asked directly after ``STOP`` on every rank at the answer's pool
    version, and the one-device engine's on the final pool; a lone
    request flushes on its deadline, no request waits past it by more
    than 0.25 s, the refresh bumps the epoch on every rank and the
    version holds after ``close()``; every rank launched
    ``fused_expand``, ``cover_counts`` and ``cover_counts_multi`` in the
    session (counters zeroed before it, read after); the flush times per
    op (worst rank) beside one device's, and the whole-mesh broadcast of
    one message alone; (b) the same as (a) under LT
    (``lt_select_expand``); (c) ``data_parallel`` IC on the same four
    ranks as 4×1: batches 0-3 and top-16, (a)'s 64-batch snapshot
    restored onto 4×1, ``refresh(0.5)`` equal to a one-device pool's, the
    coverage check per rank; (d) a 1×1 mesh over NCCL: batches 0-3 and
    top-16 through the same code, (a)'s snapshot restored onto it, the
    coverage check;
    (e) the golden ``"mesh"`` entry (4,096 vertices, batches 0-7, IC and
    LT, dense and sparse leg) on 2×2 and on a 1×3 world: every sha256 and
    every level's words.  It prints each sub-phase's seconds, each rank's
    peak device memory, the transport, the bytes staged through the host,
    and one level's exchange timed alone (all-gather, butterfly, pmax);
10. quantised golden, after the LT tile stacks are released: the port's
    whole quantised path at the golden file's ``"q"`` size (4,096
    vertices: generator, ``cluster`` reordering, q8 layout,
    ``run_fused_q_tiled`` on the dense grid and the compacted list),
    levels, popcount and sha256 of batches 0-1 against the reference's
    ``graph_q`` loop;
11. quantised main path at full size: powerlaw_cluster(262,144, 6.0,
    p=0.25, seed 7), deduped, ``reorder.apply(g, "cluster")``, reversed,
    128×128 tiles with the uint8 stack only (~600k tiles, ~9 GiB, tile ids
    past 2¹⁸ where the cell counter wraps), its slot count and how many
    pairs of slots share a cell; ``fused_expand_q`` against its
    plain version on 4,096 tile ids spread over the id range; then 8
    batches of 64 colours through ``run_fused_q_tiled`` on the dense grid
    and on the compacted list, in turns, with identical words; counters as
    in 4, ``fused_expand_q`` launched once per level of each;
12. quantised timing: the slot list as in 6; every level of batch 0 on
    both grids (CUDA graph of 10 launches), the compaction, each beside its
    bound on this card;
13. quantised exactness without the reference: (b) the mean RRR set size
    of the 512 quantised traversals against 512 exact CSR IC traversals
    (p = 0.25 quantises exactly), within 4 standard errors of the
    difference; (a) with every edge at p = 1 the quantised traversal
    equals the CSR sweep's BFS word for word (batches 0 and 1);
14. flash attention, after the quantised stacks are released: the
    kernels against their plain version on the card through
    ``ops.flash_attention``, which picks one of three routes by shape
    (``wgmma``: bf16 prefill at D 64/128; ``decode``: one query row;
    ``simt``: the rest) — float32 and bfloat16, causal and not,
    ``kv_offset`` 0 and > 0, H/KVH 1, 3, 5, 8 and 12, head dims 16, 64,
    96, 128 and 192, ragged Lq and Lk, and the LM main path's and
    maverick's (H 40, KVH 8, a group of 5) prefill and decode shapes; each
    decode case also against the split-K plain
    version cut at the kernel's own split; float32 within 2e-5 max abs,
    bfloat16 within atol = rtol = 2e-2 (the reference's kernel test) and
    a relative RMS difference of 6e-3 (``BF16_RMS_TOL``), compared in
    float32.  It prints the cases per route and fails unless each route
    ran one;
15. LM checks: (golden) llama3.2-3b at full width and vocabulary, depth
    cut to 2 layers, float32 (TF32 off), weights from
    ``models/init.py::numpy_params(cfg, seed=0)``: prefill of 2 × 64
    tokens (simt route) and 8 teacher-forced decode steps (decode route)
    against the file's ``"lm"`` entry — logits at 32 vocabulary ids, max
    logit and log-sum-exp within 1e-3, greedy argmax equal wherever the
    golden top-2 gap exceeds 1e-3; (bf16) the same model in bf16 with the
    port's seeded init, 2 × 2,048 tokens: prefill logits through the
    wgmma route against the same forward with attention through the plain
    version, within the limits stated at ``LM_BF16_MAX_TOL``; (moe
    golden) the file's two ``"moe"`` entries the same way as the
    ``"lm"`` one (float32, TF32 off, ``numpy_params`` weights, the same
    limits): deepseek-v3 (MLA + MoE) and llama4-maverick (GQA + MoE) at
    full width and vocabulary, cut to 2 layers (one dense, one MoE) and 16
    and 8 routed experts; every expert the port's router picks, call by
    call, equal to the reference's (``routes``), its router margin
    printed; deepseek launches no flash_attention, maverick 2 simt and
    2 × 8 decode;
16. LM main path at full width: llama3.2-3b, 28 layers, bf16, the port's
    seeded init, through ``launch.serve``'s ``run``: (a) the launcher's own
    mix, batch 4, prompt 32, 32 new tokens at temperature 0.7; (b) batch
    4, prompt 2,048, 32 new tokens, greedy.  Counters as in 4; each
    request batch must launch ``flash_attention`` 28 × (1 + 32) times: 28
    on the wgmma route and 28 × 32 on the decode route;
16b. MoE main path at full width, bf16, the port's seeded init, through
    ``launch.serve``'s ``serve_config`` with (a) and (b): deepseek-v3 cut
    to its 3 dense and 2 MoE layers (256 routed experts, MLA), then
    llama4-maverick cut to one dense and one MoE layer (128 routed
    experts), one model on the card at a time; finite logits, tokens in
    range, peak memory under the card's; maverick launches exactly 2
    wgmma + 2 × 32 decode a request batch, deepseek none.  It prints
    prefill tokens/s, decode ms a step beside the time to read every
    expert once, each MoE layer's capacity at prefill and at decode, and
    the MLA latent cache's bytes a token against K and V of 128 heads;
16c. the expert-parallel MoE (`_moe_forward_a2a`) on a 2×2 gloo world of
    4 ranks sharing the card (`mesh_smoke.rank_moe_a2a`), each holding
    its 8 of 16 experts at deepseek-v3's widths, float32: every rank's
    output against the golden ``"moe_a2a"`` entry within 1e-4 (256
    values, aux, the magnitude sum) with every expert pick the
    reference's; at capacity factor 64 equal to the one-device scatter
    within 1e-4; the all-to-all's bytes and host-clock ms per rank;
17. flash timing at (b)'s prefill and decode shapes: the route the main
    path takes and the simt route (the CUDA-core kernel) from CUDA graphs of
    10 launches, the plain version and, as the library's time,
    ``scaled_dot_product_attention(..., enable_gqa=True)`` (timed only;
    the port never calls it) from a CUDA graph of 10 launches and with
    events around one eager call, each beside the function's bound.

Each phase prints its peak device memory (9b, 9c and 9d their seconds
too).
Phases 6a, 6b, 9a and 9b each build their own graph and 24.2 GiB tile
layout, after the phase before is released; a delta's rebind holds the old and new layouts for a moment.  The line before the last is the
card's name and power limit as ``nvidia-smi`` reports them; the last line
is the result object.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.json")

# Published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit: HBM3
# rate, and the rate of 32-bit operations outside the tensor cores (the
# float32 figure; the kernels' integer operations issue no faster).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12     # dense tensor-core peak (bf16 inputs)
F32_TOL, BF16_TOL, LM_TOL = 2e-5, 2e-2, 1e-3
# bf16 kernel checks also bound the relative RMS difference, rms(got -
# want) / rms(want): atol = rtol = 2e-2 alone is a third of a typical
# output at the main prefill shape (~0.07).  Both sides are rounded to
# bf16 (half a step is 2^-9..2^-8 relative), and the wgmma route rounds P
# to bf16 for P.V: a plain float32 emulation of that gives about 2e-3 at
# the flash cases' shapes, so 6e-3 passes a sound kernel and fails one
# that is off by ~1% of its output.
BF16_RMS_TOL = 6e-3
# The bf16 whole-model check (phase 15): llama3.2-3b at full width, 2
# layers, bf16, batch 2 x prompt 2,048, prefill logits through the kernels
# against the same model with attention through the plain version.  The
# two differ only in the attention output's rounding (the kernel rounds P
# to bf16 for P.V; both round the output to bf16), which the two bf16
# layers carry on to the bf16 logits.  Those have a spread of ~1 and reach
# |6|, where one bf16 step is 0.031: the max limit is about three such
# steps, the mean limit about one step at |logit| ~ 2.  Greedy tokens must
# agree wherever the plain run's top-2 gap exceeds twice the max limit.
LM_BF16_LAYERS, LM_BF16_BATCH, LM_BF16_PROMPT = 2, 2, 2048
LM_BF16_MAX_TOL, LM_BF16_MEAN_TOL = 0.1, 0.01
# The LM main path: llama3.2-3b, request mixes (a) and (b) (module docstring).
LM_ARCH, LM_BATCH, LM_NEW = "llama3.2-3b", 4, 32
LM_MIXES = {"a": (32, 0.7), "b": (2048, 0.0)}
# The MoE phases: every expert the port's router picks must be the
# reference's (the golden entries' ``routes``), so a flipped expert cannot
# hide behind LM_TOL; the golden's router margin (its nearest tie) is
# printed beside the picks.  The main path's depth cuts at full width
# (deepseek-v3: its 3 dense layers and 2 MoE layers; maverick: one dense
# and one MoE layer) are served with LM_MIXES; MOE_A2A_TOL bounds the a2a
# against the golden entry and the one-device scatter.
MOE_A2A_TOL = 1e-4
MOE_MAIN = {"deepseek-v3-671b": 5, "llama4-maverick-400b-a17b": 2}
# Integer operations of the counter hash (core/rng.py): one fold is
# 2 shifts + 3 adds + 1 xor, then mix32 is 3 shift-xor pairs + 2 multiplies;
# a colour draw adds shift, convert, scale and compare.
OPS_PER_EDGE_FOLD = 14
OPS_PER_DRAW = 18
# A quantised draw: one fold (14) serves four colours, each of which adds a
# shift, a mask and a compare; counted as 20 per hash.
OPS_PER_Q_HASH = 20
# The quantised path (phases 10-13): its graph, batches, check list and the
# statistics limit in standard errors of the difference of two means.
Q_N, Q_DEGREE, Q_PROB, Q_GRAPH_SEED = 262_144, 6.0, 0.25, 7
Q_BATCHES, Q_CHECK_TILES, Q_STAT_SE = 8, 4096, 4.0
# The fused-versus-unfused phases (9b, 9c): forward σ's trials and counter
# seed, the fresh reverse collection and the limit in standard errors;
# the Table-1 grid's graph, edge probabilities, colours, counter seed and
# the host seconds of unfused runs a point may take (at most 3 runs).
SIGMA_TRIALS, SIGMA_MASTER_SEED, SIGMA_SE = 512, 77, 4.0
FRESH_THETA, FRESH_SEED = 4096, 4242
T1_NAME, T1_GRAPH_SEED, T1_SEED = "web-Google", 2, 1
T1_PROBS, T1_COLORS, UNFUSED_BUDGET_S = (0.05, 0.1, 0.2), (8, 32, 64), 4.0


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _sha(mask: torch.Tensor) -> str:
    words = mask.cpu().numpy().view(np.uint32).astype("<u4")
    return hashlib.sha256(words.tobytes()).hexdigest()


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest difference of the uint32 words (0 when bit-identical)."""
    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64)
                                                 & 0xFFFFFFFF)
    return int(diff.abs().max()) if diff.numel() else 0


def _time_ms(fn, reps: int, before=None) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` runs; ``before`` runs
    untimed ahead of each (an L2 flush)."""
    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _random_masks(vp, colors, density, gen, dev):
    """(frontier, visited ⊇ frontier) int32 masks with random bits."""
    from repro_torch.core import bitmask
    w = bitmask.num_words(colors)
    tail = bitmask.tail_mask_tensor(colors, dev)

    def bits(p):
        lanes = torch.rand((vp, w, 32), generator=gen, device=dev) < p
        return bitmask.pack_bits(lanes) & tail

    fr = bits(density)
    return fr, fr | bits(0.2)


# ------------------------------------------------------------------ phases
def _reduced_graph(dev, lt: bool):
    """The reduced check graph: 4,096 vertices, destinations below 3,000 so
    blocks 24..31 receive no tile, 5 ``pad_tiles_to`` padding tiles; LT
    adds the normalised weights and the cb stack.  Returns (graph, tiles,
    cb or None)."""
    from repro_torch.core import lt as lt_lib
    from repro_torch.core import tiles
    from repro_torch.graph import csr

    rs = np.random.default_rng(11)
    n, e = 4096, 40_000
    src = rs.integers(0, n, e)
    dst = rs.integers(0, 3000, e)
    keep = src != dst
    g = csr.from_edges(src[keep], dst[keep],
                       rs.uniform(0, 1, keep.sum()).astype(np.float32), n,
                       dedupe=True, device=dev)
    if lt:
        g = lt_lib.normalize_lt_weights(g)
    nt = tiles.from_graph(g, edge_ids=not lt).num_tiles
    tg = tiles.from_graph(g, pad_tiles_to=nt + 5, edge_ids=not lt)
    ptr = tg.dst_run_ptr
    _check(bool((ptr[1:] == ptr[:-1]).any()), "reduced graph lacks empty "
           "destination blocks")
    cb = (tiles.lt_cb_tiles(tg, g, lt_lib.selection_cum_before(g))
          if lt else None)
    return g, tg, cb


def _hub_graph(dev, lt: bool = False):
    """4,096 vertices whose rows 5, 700 and 4,095 take 300 in-edges each
    (row 5's from three source blocks, the others' from anywhere), plus
    5,000 random edges: a warp's 32 entries often share a destination row,
    and one row's entries spread over many tiles.  Returns the tiles, and
    for LT (normalised weights) the cb stack, else None."""
    from repro_torch.core import lt as lt_lib
    from repro_torch.core import tiles
    from repro_torch.graph import csr

    n = 4096
    rs = np.random.default_rng(1)
    src = np.concatenate([np.arange(1000, 1300), rs.integers(0, n, 600),
                          rs.integers(0, n, 5000)])
    dst = np.concatenate([np.repeat([5, 700, 4095], 300),
                          rs.integers(0, n, 5000)])
    keep = src != dst
    g = csr.from_edges(src[keep], dst[keep],
                       rs.uniform(0.05, 0.5, keep.sum()).astype(np.float32),
                       n, dedupe=True, device=dev)
    if not lt:
        return tiles.from_graph(g), None
    g = lt_lib.normalize_lt_weights(g)
    tg = tiles.from_graph(g, edge_ids=False)
    return tg, tiles.lt_cb_tiles(tg, g, lt_lib.selection_cum_before(g))


def _same_lists(a, b) -> bool:
    """Two slot lists equal field for field."""
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "slot_ptr", "src_row", "dst_row", "value", "key")) \
        and a.value.dtype == b.value.dtype \
        and (a.src_rows, a.dst_rows) == (b.src_rows, b.dst_rows)


def check_slot_lists(dev, gen, err: dict) -> None:
    """The slot lists and the kernels that walk them, beyond the tile
    cases of `check_kernels`: each list (IC, quantised, LT) holds exactly
    the slots that pass its value test and equals the list read back from
    the stack; a hub destination (300 in-edges a row) and W = 8 on the
    three kernels, against the tile-form plain versions, on the dense grid
    and the full list."""
    from repro_torch.core import tiles
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_expand_q import quantize_probs

    g, tg, _ = _reduced_graph(dev, False)
    _, tl, cb = _reduced_graph(dev, True)
    tq, q8 = tiles.quantized(g)
    ic, q = tiles.ic_slot_list(tg), tiles.q_slot_list(tq, q8)
    lt = tiles.lt_slot_list(tl, cb)
    _check(ic.num_entries == int((tg.prob > 0).sum())
           and q.num_entries == int((q8 > 0).sum())
           and lt.num_entries == int((tl.prob > 0).sum()),
           "a slot list does not hold exactly the slots that pass its test")
    _check(_same_lists(ic, tiles.ic_slot_list_from_stack(tg))
           and _same_lists(q, tiles.q_slot_list_from_stack(tq, q8))
           and _same_lists(lt, tiles.lt_slot_list_from_stack(tl, cb)),
           "the list built from the host arrays differs from the one read "
           "from the stack")
    print(f"[kernels] slot lists of the reduced graph: IC {ic.num_entries} "
          f"entries (= slots with prob > 0), quantised {q.num_entries} (= "
          f"slots with q > 0, of {int((tg.prob > 0).sum())} with prob > 0), "
          f"LT {lt.num_entries} (= slots with prob > 0 of the normalised "
          "graph); each built from the host arrays and equal to the list "
          "read back from its stack")
    cases = 0
    for name, (tl, cb) in (("reduced", (tl, cb)),
                           ("hub", _hub_graph(dev, lt=True))):
        full = tiles.active_tile_ids(
            tl.tile_src, torch.ones(tl.num_blocks, dtype=torch.bool,
                                    device=dev))
        for colors, density in ((256, 0.05), (256, 0.9), (32, 0.9)):
            u = ref.lt_selection_uniforms(0xDEADBEEF, tl.padded_vertices,
                                          colors, device=dev)
            fr, vis = _random_masks(tl.padded_vertices, colors, density, gen,
                                    dev)
            want = ref.lt_select_expand_ref(tl.prob, cb, tl.tile_src,
                                            tl.tile_dst, fr, vis, u)
            for ids in (None, full):
                got = ops.lt_select_expand(tl, cb, fr, vis, u, tile_ids=ids)
                torch.cuda.synchronize()
                err["lt_select_expand"] = max(err["lt_select_expand"],
                                              _max_abs_err(got, want))
        if name == "hub":
            lt_hub = int((tiles.lt_slot_list(tl, cb).dst_row == 700).sum())
            _check(lt_hub >= 250, f"LT hub row 700 has {lt_hub} entries")
    print(f"[kernels] lt_select_expand on its slot list at W 8 and 1 (dense "
          f"grid and full list) on the reduced graph and the hub graph (row "
          f"700: {lt_hub} entries): max word diff {err['lt_select_expand']}")
    for name, (tg, _) in (("reduced", (tg, None)), ("hub", _hub_graph(dev))):
        q8 = quantize_probs(tg.prob)
        full = tiles.active_tile_ids(
            tg.tile_src, torch.ones(tg.num_blocks, dtype=torch.bool,
                                    device=dev))
        for colors, density in ((256, 0.05), (256, 0.5), (32, 0.5)):
            fr, vis = _random_masks(tg.padded_vertices, colors, density, gen,
                                    dev)
            for ids in (None, full):
                got = ops.fused_expand(tg, fr, vis, 0xDEADBEEF, 17,
                                       tile_ids=ids)
                want = ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                            tg.tile_dst, fr, vis, 0xDEADBEEF,
                                            17)
                err["fused_expand"] = max(err["fused_expand"],
                                          _max_abs_err(got, want))
                got = ops.fused_expand_q(tg, q8, fr, vis, 0xDEADBEEF, 17,
                                         tile_ids=ids)
                want = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst,
                                              fr, vis, 0xDEADBEEF, 17)
                torch.cuda.synchronize()
                err["fused_expand_q"] = max(err["fused_expand_q"],
                                            _max_abs_err(got, want))
                cases += 1
        if name == "hub":
            hub = int((tiles.ic_slot_list(tg).dst_row == 700).sum())
            _check(hub >= 250, f"hub row 700 has {hub} entries")
    print(f"[kernels] fused_expand and fused_expand_q: {cases} cases each "
          f"at W 8 and 1 (dense grid and full list) on the reduced graph and "
          f"on a hub graph (row 700: {hub} entries); max word diff "
          f"{err['fused_expand']} / {err['fused_expand_q']}")


def _tile_lists(tg, fr):
    """(name, tile_ids, frontier) cases of the compacted-list checks: every
    tile (None), the empty list, one source block, the full list."""
    from repro_torch.core import tiles

    act = torch.zeros(tg.num_blocks, dtype=torch.bool, device=fr.device)
    cases = [("dense grid", None, fr),
             ("empty list", tiles.active_tile_ids(tg.tile_src, act), fr)]
    act[int(tg.tile_src[0])] = True
    one = fr * act.repeat_interleave(tg.tile_size)[:, None]
    cases.append(("one source block", tiles.active_tile_ids(tg.tile_src, act),
                  one))
    act[:] = True
    cases.append(("full list", tiles.active_tile_ids(tg.tile_src, act), fr))
    return cases


def check_kernels(dev) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest word difference seen per kernel (0 = bit-identical)."""
    from repro_torch.kernels import ops, ref

    from repro_torch.kernels.fused_expand_q import quantize_probs

    err = {"fused_expand": 0, "cover_counts": 0, "lt_select_expand": 0,
           "fused_expand_q": 0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for lt in (False, True):
        name = "lt_select_expand" if lt else "fused_expand"
        _, tg, cb = _reduced_graph(dev, lt)
        cases = 0
        for colors in (32, 64, 96, 256):
            u = ref.lt_selection_uniforms(0xDEADBEEF, tg.padded_vertices,
                                          colors, device=dev)
            for density in (0.0, 0.02, 0.3):
                fr0, vis = _random_masks(tg.padded_vertices, colors, density,
                                         gen, dev)
                for _, ids, fr in _tile_lists(tg, fr0):
                    sel = slice(None) if ids is None else ids.long()
                    stacks = (tg.prob[sel], cb[sel] if lt else
                              tg.edge_id[sel], tg.tile_src[sel],
                              tg.tile_dst[sel])
                    if lt:
                        got = ops.lt_select_expand(tg, cb, fr, vis, u,
                                                   tile_ids=ids)
                        want = ref.lt_select_expand_ref(*stacks, fr, vis, u)
                    else:
                        got = ops.fused_expand(tg, fr, vis, 0xDEADBEEF, 17,
                                               tile_ids=ids)
                        want = ref.fused_expand_ref(*stacks, fr, vis,
                                                    0xDEADBEEF, 17)
                    torch.cuda.synchronize()
                    err[name] = max(err[name], _max_abs_err(got, want))
                    _check(bool(fr.any()) or not bool(got.any()),
                           f"{name}: an empty frontier expanded")
                    cases += 1
        print(f"[kernels] {name}: {cases} cases on a 4096-vertex graph "
              f"({tg.num_tiles} tiles, 5 padding; W 1, 2, 3, 8; every tile "
              f"and compacted lists: empty, one source block, full), max "
              f"word diff {err[name]}")
        if lt:
            continue
        # The quantised kernel on the same tiles: q8 is the reference's
        # quantize_probs of the float32 stack (its slot list read from the
        # stack); W = 1, 2, 4 and 8.
        q8, cases = quantize_probs(tg.prob), 0
        for colors in (32, 64, 128, 256):
            for density in (0.0, 0.02, 0.3):
                fr0, vis = _random_masks(tg.padded_vertices, colors, density,
                                         gen, dev)
                for _, ids, fr in _tile_lists(tg, fr0):
                    got = ops.fused_expand_q(tg, q8, fr, vis, 0xDEADBEEF, 17,
                                             tile_ids=ids)
                    want = ref.fused_expand_q_ref(
                        q8, tg.tile_src, tg.tile_dst, fr, vis, 0xDEADBEEF, 17,
                        tile_ids=ids)
                    torch.cuda.synchronize()
                    err["fused_expand_q"] = max(err["fused_expand_q"],
                                                _max_abs_err(got, want))
                    _check(bool(fr.any()) or not bool(got.any()),
                           "fused_expand_q: an empty frontier expanded")
                    cases += 1
        print(f"[kernels] fused_expand_q: {cases} cases on the same graph "
              f"(W 1, 2, 4, 8; every tile and the three compacted lists), "
              f"max word diff {err['fused_expand_q']}")
    check_slot_lists(dev, gen, err)
    shapes = ((64, 65536, 2), (64, 65536, 1), (64, 65536, 8),
              (16, 65536, 3), (1, 300, 1), (5, 257, 5))
    for b, v, w in shapes:
        vis = torch.randint(-2 ** 31, 2 ** 31, (b, v, w), dtype=torch.int32,
                            device=dev, generator=gen)
        act = torch.randint(-2 ** 31, 2 ** 31, (b, 8, w), dtype=torch.int32,
                            device=dev, generator=gen)
        got = ops.cover_counts(vis, act[:, 0])
        want = ref.cover_counts_ref(vis, act[:, 0])
        got_q = ops.cover_counts_multi(vis, act)
        want_q = ref.cover_counts_multi_ref(vis, act)
        err["cover_counts"] = max(err["cover_counts"],
                                  _max_abs_err(got, want),
                                  _max_abs_err(got_q, want_q))
    print(f"[kernels] cover_counts and cover_counts_multi (Q 8): (B, V, W) "
          f"{list(shapes)}, max diff {err['cover_counts']}")
    _check(not any(err.values()),
           f"kernel disagrees with its plain version: {err}")
    return err


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def run_main_path(golden: dict, diffusion: str) -> tuple[dict, dict]:
    """The serving launcher at full size on the kernel backend (IC on the
    dense grid, LT on the compacted grid); returns its summary and the
    launch counts of exactly this run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_influence

    extra = ["--diffusion", "lt", "--frontier", "sparse"] \
        if diffusion == "lt" else []
    args = serve_influence.parse_args([
        "--device", "cuda", "--smoke", "--sampler-backend", "kernel",
        "--n", str(golden["graph"]["n"]), "--colors", "64",
        "--batches", "64", "--max-batches", "64", "--k", "16",
        "--queries", "6", "--theta-cap", "4096", *extra])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve_influence.run_single(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"[main {diffusion}] launches on the main path: {launches}; peak "
          f"device memory {_peak_gib():.2f} GiB")
    kernel = "lt_select_expand" if diffusion == "lt" else "fused_expand"
    _check(launches[kernel] > 0 and launches["cover_counts"] > 0,
           f"a kernel of the {diffusion} path never launched: {launches}")
    # The run's flushes that compute marginal gains: the first and the one
    # after the refresh (the re-serve between them is all cache hits), each
    # one dispatch per query_slots queries, each dispatch one launch for all
    # its slots (one per slot before: query_slots launches a dispatch).
    slots = out["engine"].query_slots
    dispatches = 2 * -(-args.queries // slots)
    _check(launches["cover_counts_multi"] == dispatches,
           f"the {diffusion} marginal flushes launched cover_counts_multi "
           f"{launches['cover_counts_multi']} times, not once for each of "
           f"their {dispatches} dispatches")
    print(f"[main {diffusion}] marginal gains: {dispatches} dispatches of "
          f"{args.queries} queries in {slots} slots, "
          f"{launches['cover_counts_multi']} cover_counts_multi launches "
          f"(one a dispatch, not {slots}); the other "
          f"{launches['cover_counts'] - launches['cover_counts_multi']} "
          f"cover_counts launches are greedy picks")
    return out, launches


def check_outputs(out: dict, golden: dict) -> None:
    """Shapes, finiteness and the full-size golden values."""
    from repro_torch.core import imm
    from repro_torch.sampling import SamplerSpec, make_sampler

    store = out["store"]
    tg = store.sampler.tg_rev
    n = store.graph.num_vertices
    print(f"[main] graph: {n} vertices, {store.graph.num_edges} edges, "
          f"{tg.num_tiles} tiles")
    _check(tg.num_tiles == golden["graph"]["num_tiles"]
           and store.graph.num_edges == golden["graph"]["num_edges"],
           "graph or tile layout differs from the reference")
    tickets, results = out["tickets"], out["results"]
    seeds, sigma = results[tickets["top_k"][0]]
    _check(seeds.shape == (16,) and np.isfinite(sigma) and sigma > 0,
           "top-k answer malformed")
    for t in tickets["sigma"]:
        _check(np.isfinite(results[t]) and 0 < results[t] <= n,
               "σ answer malformed")
    for t in tickets["marginal"]:
        gains = results[t]
        _check(gains.shape == (n,) and np.isfinite(gains).all()
               and (gains >= 0).all(), "marginal answer malformed")
    res = out["imm"]
    _check(res.theta <= 4096 and 0 < res.coverage <= 1
           and res.seeds.shape == (16,), "run_imm result malformed")
    print(f"[main] run_imm: θ={res.theta}, coverage {res.coverage:.6f}, "
          f"σ̂={res.sigma_estimate:.1f}, seeds {res.seeds.tolist()}")

    torch.cuda.reset_peak_memory_stats()
    kern = store.sampler.sample_many(range(4))
    for b, gb in zip(kern, golden["batches"]):
        _check(_sha(b.visited) == gb["visited_sha256"],
               f"kernel batch {b.batch_index} differs from the reference")
    top, cov = imm.greedy_max_cover(torch.stack([b.visited for b in kern]),
                                    16, 64)
    _check(top.tolist() == golden["top_k"]["seeds"]
           and cov == golden["top_k"]["coverage"],
           f"top-16 over batches 0-3 {top.tolist()} != reference")
    dense = make_sampler(store.graph, SamplerSpec(backend="dense"),
                         g_rev=store.g_rev).sample_many(range(2))
    for d, k, gb in zip(dense, kern, golden["batches"]):
        _check(torch.equal(d.visited, k.visited)
               and _sha(d.visited) == gb["visited_sha256"]
               and d.fused_edge_visits == gb["fused_edge_visits"]
               and d.unfused_edge_visits == gb["unfused_edge_visits"],
               f"dense batch {d.batch_index} differs from kernel/reference")
    compact = make_sampler(store.graph, SamplerSpec(
        backend="kernel", frontier="sparse"), g_rev=store.g_rev)
    steps = []
    for b, gb in zip(range(4), golden["batches"]):
        _check(_sha(compact.sample(b).visited) == gb["visited_sha256"],
               f"compacted-grid kernel batch {b} differs from the reference")
        steps.append((compact.last_active_tiles, compact.last_grid_steps,
                      compact.last_levels * tg.num_tiles))
    print("[golden] kernel batches 0-3 (dense grid and compacted grid), dense "
          "batches 0-1 and the top-16 seeds equal the reference bit for bit "
          f"(fused edge visits {[d.fused_edge_visits for d in dense]}); "
          f"compacted grid (tiles walked, grid_steps, dense-grid steps) per "
          f"batch {steps}; peak device memory {_peak_gib():.2f} GiB")


def _kernel_ms(fn, launches: int = 10) -> float:
    """Device time of one launch of ``fn``: ``launches`` launches captured
    in one CUDA graph and replayed between two events, so no host dispatch
    lies between them (L2 warm after the first)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def time_tile_kernel(store, diffusion: str) -> dict:
    """Every level of batch 0 through the tile kernel's CUDA wrapper on the
    dense grid and on the level's compacted tile list (built outside the
    timed window; `_kernel_ms`), the compaction itself (the tile list; CUDA
    events), and the plain version (IC: the tile form over the whole
    stacks, as the dense grid; LT: the tile form on the gathered list, as
    the compacted grid its main path runs); all equal at every level.  Each
    reads its slot list back from the stacks (timed) and holds it equal to
    the one the layout built.  The
    eager timings run in a first pass over the levels, the CUDA graphs in a
    second, so graph memory does not disturb the allocator under them.
    Each level's bound counts what its data needs: prob and edge id (IC)
    or prob and cb (LT) of every edge whose source row is live, the uniform
    of every tested (edge, colour) pair (LT), the output mask, the run
    pointers, and on the dense grid the whole frontier and visited masks
    and every tile's source block; on the compacted list only the frontier
    rows of the listed tiles' source blocks, the visited rows of the
    destination blocks they reach, and each entry's id and source block;
    one edge fold and one draw per tested pair (IC), one add and two
    compares (LT)."""
    from repro_torch.core import bitmask, sparse, tiles, traversal
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_expand import fused_expand_cuda
    from repro_torch.kernels.lt_select_expand import lt_select_expand_cuda
    from repro_torch.sampling import make_sampler

    lt = diffusion == "lt"
    name = "lt_select_expand" if lt else "fused_expand"
    sampler, g_rev = store.sampler, store.g_rev
    tg = sampler.tg_rev
    dev = tg.prob.device
    seed = sampler.batch_seed(0)
    fr = tiles.pad_mask_rows(traversal.init_frontier(
        tg.num_vertices, 64, sampler.batch_starts(0), dev),
        tg.padded_vertices)
    vis = torch.zeros_like(fr)
    cb = u = None
    if lt:
        cb = sampler._cb_tiles
        u = ref.lt_selection_uniforms(seed, tg.padded_vertices, 64,
                                      device=dev)

    slots = tiles.lt_slot_list(tg, cb) if lt else tiles.ic_slot_list(tg)

    def kernel(level, fr, vis, ids):
        if lt:
            return lt_select_expand_cuda(slots, fr, vis, u, tile_ids=ids)
        return fused_expand_cuda(slots, fr, vis, seed, level, tile_ids=ids)

    def plain(level, fr, vis, ids):
        if lt:
            sel = ids.long()
            return ref.lt_select_expand_ref(tg.prob[sel], cb[sel],
                                            tg.tile_src[sel],
                                            tg.tile_dst[sel], fr, vis, u)
        return ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                    tg.tile_dst, fr, vis, seed, level)

    def compact(fr):
        return tiles.active_tile_ids(
            tg.tile_src, sparse.row_block_activity(fr, tg.tile_size))

    t0 = time.perf_counter()
    again = (tiles.lt_slot_list_from_stack(tg, cb) if lt
             else tiles.ic_slot_list_from_stack(tg))
    torch.cuda.synchronize()
    per = dict(slot_entries=slots.num_entries, slot_bytes=slots.nbytes,
               slot_build_ms=1e3 * (time.perf_counter() - t0))
    _check(_same_lists(again, slots), f"{name}: the slot list read from the "
           "stacks differs from the layout's")
    del again
    print(f"[timing] {name} slot list: {slots.num_entries} entries "
          f"({slots.nbytes / 2 ** 20:.2f} MiB) built with the layout "
          f"from its host arrays; read back from the stacks in "
          f"{per['slot_build_ms']:.1f} ms, equal")

    src = g_rev.src[:g_rev.num_edges].long()
    dst = g_rev.dst[:g_rev.num_edges].long()
    row_bytes = tg.tile_size * fr.shape[1] * 4
    ptr_bytes = (tg.num_blocks + 1) * 4
    t = {k: [] for k in ("dense", "compact", "compaction", "plain",
                         "bytes_dense", "bytes_compact", "ops", "tiles")}
    # Pass 1, eager: the levels' masks and lists, the checks, the bounds,
    # and the compaction and plain-version times (CUDA events).
    levels, err = [], 0
    while len(levels) < 64 and bitmask.any_set(fr):
        level = len(levels)
        vis = vis | fr
        ids = compact(fr)
        t["compaction"].append(_time_ms(lambda: compact(fr), 3))
        nf = kernel(level, fr, vis, None)
        nf_c = kernel(level, fr, vis, ids)
        want = [None]

        def run_plain():
            want[0] = plain(level, fr, vis, ids)
        t["plain"].append(_time_ms(run_plain, 1))
        err = max(err, _max_abs_err(nf, want[0]), _max_abs_err(nf_c, nf))
        fr_src = fr[src]
        live = (fr_src != 0).any(1)
        pairs = int(bitmask.popcount(fr_src[live] & ~vis[dst[live]]).sum())
        n_live = int(live.sum())
        edge_bytes = n_live * 8 + (pairs * 4 if lt else 0)
        out_bytes = fr.numel() * 4
        listed = ids.long()
        n_src = int(torch.unique(tg.tile_src[listed]).numel())
        n_dst = int(torch.unique(tg.tile_dst[listed]).numel())
        t["bytes_dense"].append(edge_bytes + 3 * out_bytes
                                + tg.num_tiles * 4 + ptr_bytes)
        t["bytes_compact"].append(edge_bytes + out_bytes
                                  + (n_src + n_dst) * row_bytes
                                  + ids.numel() * 8 + ptr_bytes)
        t["ops"].append(n_live + 3 * pairs if lt else
                        n_live * OPS_PER_EDGE_FOLD + pairs * OPS_PER_DRAW)
        t["tiles"].append(int(ids.numel()))
        levels.append((fr, vis, ids))
        fr = nf
    # Pass 2: each level's kernel on both grids, device time per launch.
    for level, (fr, vis, ids) in enumerate(levels):
        t["dense"].append(_kernel_ms(lambda: kernel(level, fr, vis, None)))
        t["compact"].append(_kernel_ms(lambda: kernel(level, fr, vis, ids)))
    level = len(levels)
    del levels
    _check(err == 0, f"{name} differs from its plain version or between its "
           f"grids at full size: max word diff {err}")
    ops_s = np.asarray(t["ops"]) / SCALAR_OPS_PER_S
    per.update(levels=level, compaction_ms=float(np.mean(t["compaction"])),
               plain_ms=float(np.mean(t["plain"])), max_abs_err=err,
               tiles=float(np.mean(t["tiles"])))
    for grid in ("dense", "compact"):
        bytes_s = np.asarray(t[f"bytes_{grid}"]) / HBM_BYTES_PER_S
        per[f"{grid}_ms"] = float(np.mean(t[grid]))
        per[f"{grid}_bound_ms"] = float(np.mean(1e3 * np.maximum(bytes_s,
                                                                 ops_s)))
        per[f"{grid}_bound_by"] = ("bytes" if bytes_s.sum() >= ops_s.sum()
                                   else "operations")
    print(f"[timing] {name} over the {level} levels of batch 0, device time "
          f"per launch (CUDA graph of 10): dense grid mean "
          f"{per['dense_ms']:.4f} ms (max {np.max(t['dense']):.4f}, bound "
          f"{per['dense_bound_ms']:.6f} by {per['dense_bound_by']}); "
          f"compacted list mean {per['compact_ms']:.4f} ms (max "
          f"{np.max(t['compact']):.4f}, bound {per['compact_bound_ms']:.6f} "
          f"by {per['compact_bound_by']}; {per['tiles']:.0f} of "
          f"{tg.num_tiles} tiles on average); compaction (tile list) "
          f"{per['compaction_ms']:.4f} ms; plain {per['plain_ms']:.4f} ms")
    for k in ("dense", "compact", "compaction", "tiles"):
        print(f"[timing] {name} {k} per level: "
              f"{[round(x, 4) for x in t[k]]}")
    # Host clock around whole batches on both grids, in turns: the kernel's
    # share of a batch is how busy the per-level loop keeps the card.
    other = make_sampler(store.graph, dataclasses.replace(
        store.spec, frontier="dense" if store.spec.frontier == "sparse"
        else "sparse"))
    samplers = {store.spec.frontier: sampler, other.spec.frontier: other}
    batch_ms = {"dense": [], "sparse": []}
    for frontier in ("dense", "sparse", "sparse", "dense"):
        t0 = time.perf_counter()
        samplers[frontier].sample(0)
        torch.cuda.synchronize()
        batch_ms[frontier].append(1e3 * (time.perf_counter() - t0))
    for frontier, grid in (("dense", "dense"), ("sparse", "compact")):
        ms = float(np.mean(batch_ms[frontier]))
        per[f"batch_{grid}_ms"] = ms
        print(f"[timing] {diffusion} batch 0 end to end, {grid} grid: "
              f"{ms:.2f} ms (runs {[round(x, 2) for x in batch_ms[frontier]]})"
              f"; its levels' kernel times sum to {np.sum(t[grid]):.2f} ms "
              f"({np.sum(t[grid]) / ms:.1%})")
    return per


def check_outputs_lt(out: dict, golden: dict) -> None:
    """LT: the pool's answers, its tile stacks, and the golden batches on
    both grids and on the dense CSR backend."""
    from repro_torch.core import imm
    from repro_torch.sampling import SamplerSpec, make_sampler

    store = out["store"]
    tg = store.sampler.tg_rev
    stack_gib = 2 * tg.num_tiles * tg.tile_size ** 2 * 4 / 2 ** 30
    print(f"[main lt] {tg.num_tiles} tiles; prob + cb stacks "
          f"{stack_gib:.1f} GiB by reckoning (no edge-id stack)")
    _check(tg.num_tiles == golden["graph"]["num_tiles"]
           and tg.edge_id is None,
           "LT tile layout differs from the reference or carries edge ids")
    tickets, results = out["tickets"], out["results"]
    seeds, sigma = results[tickets["top_k"][0]]
    _check(seeds.shape == (16,) and np.isfinite(sigma) and sigma > 0,
           "LT top-k answer malformed")
    res = out["imm"]
    _check(res.theta <= 4096 and 0 < res.coverage <= 1
           and res.seeds.shape == (16,), "LT run_imm result malformed")
    print(f"[main lt] run_imm: θ={res.theta}, coverage {res.coverage:.6f}, "
          f"σ̂={res.sigma_estimate:.1f}, seeds {res.seeds.tolist()}")

    torch.cuda.reset_peak_memory_stats()
    gold = golden["lt"]
    compact = [store.sampler.sample(b) for b in range(4)]
    dense_grid = make_sampler(store.graph, SamplerSpec(
        diffusion="lt", backend="kernel")).sample_many(range(4))
    csr_lt = make_sampler(store.graph, SamplerSpec(
        diffusion="lt")).sample_many(range(2))
    for grid, batches in (("compacted", compact), ("dense", dense_grid),
                          ("CSR", csr_lt)):
        for b, gb in zip(batches, gold["batches"]):
            _check(_sha(b.visited) == gb["visited_sha256"],
                   f"LT {grid} batch {b.batch_index} differs from the "
                   "reference")
    top, cov = imm.greedy_max_cover(torch.stack([b.visited for b in compact]),
                                    16, 64)
    _check(top.tolist() == gold["top_k"]["seeds"]
           and cov == gold["top_k"]["coverage"],
           f"LT top-16 over batches 0-3 {top.tolist()} != reference")
    print("[golden] LT kernel batches 0-3 (compacted grid and dense grid), "
          "dense CSR batches 0-1 and the top-16 seeds equal the reference "
          f"bit for bit; peak device memory {_peak_gib():.2f} GiB")


# ------------------------------------------------- serving lifecycle phases
def _release(what: str) -> None:
    """Free what the phase before held, so that each phase's peak device
    memory is its own (and two 24.2 GiB layouts never outlive a phase)."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"[release] {what} freed: {held:.2f} GiB still allocated")


def _launcher_args(golden: dict, *flags: str):
    from repro_torch.launch import serve_influence
    return serve_influence.parse_args([
        "--device", "cuda", "--sampler-backend", "kernel",
        "--n", str(golden["graph"]["n"]), "--colors", "64",
        "--batches", "64", "--max-batches", "64", "--k", "16", *flags])


def run_tier_phase(golden: dict) -> dict:
    """The serving tier at full size: ``run_tier --smoke --autoscale``, 3
    tenants over 2 replicas of the 64-batch IC pool on the kernel backend.
    The launcher checks the tier's contract; here ``cover_counts`` must
    have launched, and the latency quantiles come from the tier's own
    histogram (bucket upper bounds)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_influence

    args = _launcher_args(golden, "--tier", "--smoke", "--autoscale",
                          "--tenants", "3", "--replicas", "2")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve_influence.run_tier(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _check(launches["cover_counts"] > 0,
           f"the tier served without cover_counts: {launches}")
    lat = out["snapshot"]["latency"]["all"]
    d = out["decision"]
    res = dict(launches=launches, p50_ms=lat["p50"] * 1e3,
               p99_ms=lat["p99"] * 1e3, queries=lat["count"],
               mean_ms=lat["mean"] * 1e3, max_ms=lat["max"] * 1e3,
               shed_rate=out["snapshot"]["totals"]["shed_rate"],
               decision=f"{d.action} {d.batches_before}->{d.batches_after}",
               seconds=seconds, peak_gib=_peak_gib())
    print(f"[tier] launches {launches}; latency over {lat['count']} "
          f"queries: p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms "
          f"(histogram bucket bounds), mean {res['mean_ms']:.3f} ms, max "
          f"{res['max_ms']:.3f} ms; autoscale {res['decision']}; "
          f"{seconds:.2f}s; peak device memory {res['peak_gib']:.2f} GiB")
    return res


def _digest(g) -> dict:
    """Edge counts and the sha256 of the padded edge arrays, as the golden
    file records them."""
    out = {"num_edges": g.num_edges, "padded_edges": g.padded_edges}
    for name, dtype in (("src", "<i4"), ("dst", "<i4"), ("prob", "<f4")):
        arr = getattr(g, name).cpu().numpy().astype(dtype)
        out[f"{name}_sha256"] = hashlib.sha256(arr.tobytes()).hexdigest()
    return out


def run_stream_phase(golden: dict, diffusion: str) -> dict:
    """A streaming delta at full size through the tier on the kernel
    backend: ``run_stream`` with 64 deletions and 64 insertions (IC on the
    dense grid, LT on the compacted list).  The launcher checks the pool
    against a cold rebuild, the replicas, the refused pre/post gather and
    the shed delta; here the delta, the mutated reversed graph, the touched
    row blocks and slots 0-3 (words, levels and, for IC, the dense CSR
    sampler's edge visits) are held against the golden ``"stream"``
    entry, and the path's tile kernel must have launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_influence
    from repro_torch.sampling import SamplerSpec, make_sampler

    gold = golden["stream"]
    extra = ("--diffusion", "lt", "--frontier", "sparse") \
        if diffusion == "lt" else ()
    args = _launcher_args(golden, "--stream-smoke", "--queries",
                          str(gold["ops"]), *extra)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve_influence.run_stream(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    kernel = "lt_select_expand" if diffusion == "lt" else "fused_expand"
    _check(launches[kernel] > 0,
           f"the {diffusion} stream path never launched {kernel}: {launches}")
    peak = _peak_gib()
    report, store = out["report"], out["store"]
    d = out["delta"]
    delta_sha = hashlib.sha256(b"".join(
        np.ascontiguousarray(a).tobytes()
        for a in (d.src, d.dst, d.weight, d.insert))).hexdigest()
    _check(delta_sha == gold["delta_sha256"],
           "the delta differs from the reference's draw")
    g = gold[diffusion]
    _check(_digest(store.g_rev) == g["g_rev"],
           f"{diffusion} mutated reversed graph differs from the reference's")
    _check(report.touched_row_blocks == len(g["touched_row_blocks"]),
           f"{report.touched_row_blocks} touched row blocks, reference "
           f"{len(g['touched_row_blocks'])}")
    levels = []
    for b, gb in zip(range(4), g["batches"]):
        slot = store.batches[b]
        again = store.sampler.sample(b)
        levels.append(store.sampler.last_levels)
        _check(slot.batch_index == b
               and _sha(slot.visited) == gb["visited_sha256"]
               and torch.equal(again.visited, slot.visited)
               and store.sampler.last_levels == gb["levels"],
               f"{diffusion} slot {b} after the delta differs from the "
               f"reference (levels {store.sampler.last_levels} vs "
               f"{gb['levels']})")
    if diffusion == "ic":
        dense = make_sampler(store.graph, SamplerSpec(backend="dense"),
                             g_rev=store.g_rev).sample_many(range(4))
        for dn, gb in zip(dense, g["batches"]):
            _check(_sha(dn.visited) == gb["visited_sha256"]
                   and dn.fused_edge_visits == gb["fused_edge_visits"]
                   and dn.unfused_edge_visits == gb["unfused_edge_visits"],
                   f"dense CSR batch {dn.batch_index} on the mutated pair "
                   "differs from the reference")
        del dense
    res = dict(launches=launches, peak_gib=peak,
               touched_row_blocks=report.touched_row_blocks,
               dirty_slots=report.dirty_slots, total_slots=report.total_slots,
               refresh_s=report.refresh_s, rebind_s=report.rebind_s,
               resample_s=report.resample_s, cold_s=out["cold_s"],
               levels=levels, renormalised_edges=g["renormalised_edges"])
    print(f"[stream {diffusion}] delta +{report.inserted}/-{report.deleted}: "
          f"{report.touched_row_blocks} touched row blocks of "
          f"{-(-store.graph.num_vertices // 128)}, {report.dirty_slots}/"
          f"{report.total_slots} slots dirty; apply_plan over 2 replicas "
          f"{report.refresh_s:.3f}s = rebind {report.rebind_s:.3f}s "
          f"(layout and slot-list rebuild) + resample "
          f"{report.resample_s:.3f}s; cold rebuild of all "
          f"{report.total_slots} slots {out['cold_s']:.3f}s; slots 0-3 "
          f"(levels {levels}) equal the reference's"
          + (" (dense CSR edge visits too)" if diffusion == "ic" else
             f" (the reference's sampler renormalises "
             f"{g['renormalised_edges']} weights once more; the port "
             "samples the mutated graph as it is)")
          + f"; launches {launches}; peak device memory {peak:.2f} GiB")
    if diffusion == "ic":
        res["driver"] = run_driver_check(store)
    return res


def run_driver_check(store) -> dict:
    """`SamplingDriver` on the kernel backend over the mutated pair: 4
    worker threads, 20% injected failures, 16 batches, which must equal the
    store's slots 0-15 word for word."""
    from repro_torch.core.driver import SamplingDriver
    from repro_torch.kernels import ops

    ops.reset_launches()
    drv = SamplingDriver(store.g_rev, store.num_colors, store.master_seed,
                         num_workers=4, failure_rate=0.2, max_attempts=20,
                         spec=store.spec)
    t0 = time.perf_counter()
    batches = drv.run(16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    _check(launches["fused_expand"] > 0,
           f"the driver's workers never launched fused_expand: {launches}")
    for i, b in enumerate(batches):
        _check(store.batches[i].batch_index == i
               and torch.equal(b.visited, store.batches[i].visited),
               f"driver batch {i} differs from the store's slot {i}")
    st = drv.stats
    print(f"[driver] 16 batches on 4 workers at failure rate 0.2 in "
          f"{seconds:.3f}s: {st.failures} failures, {st.reissues} "
          f"reissues, {st.speculative} speculative; equal to the store's "
          f"slots 0-15 word for word; launches {launches}")
    return dict(launches=launches, seconds=seconds, failures=st.failures,
                reissues=st.reissues, speculative=st.speculative)


def time_cover_counts(store) -> dict:
    """cover_counts at the pool's shape as device time: cold (the greedy
    loop's first pick, L2 flushed) from a CUDA graph of 10 (flush memset,
    kernel) pairs minus a graph of the 10 flushes alone, and warm (later
    picks find the 33.5 MB stack in the 50 MB L2) from a graph of 10
    launches; beside them the events-around-one-eager-call figure of
    earlier runs, and the cold time after a flush that reads 256 MB (L2
    left clean, no write-backs of the memset's dirty lines).  The Q = 8
    form on a marginal flush's eight active masks
    (8 exclusion sets of 2 vertices), cold and warm, against 8 launches of
    the Q = 1 form on the same masks.  Each beside its bound."""
    from repro_torch.core import bitmask, imm
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.influence import engine

    vis = store.visited_stack()
    b, v, w = vis.shape
    dev, q = vis.device, 8
    act = imm.initial_active(b, store.num_colors, dev)
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, v, (q, 2))).to(dev)
    act_q = (bitmask.tail_mask_tensor(store.num_colors, dev) & ~engine
             ._union_rows(vis, seeds, torch.ones_like(seeds, dtype=bool)))
    act_q = act_q.contiguous()
    slots = [act_q[:, k].contiguous() for k in range(q)]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush_ms = _kernel_ms(flush.zero_)
    # A flush that reads instead leaves L2 clean: the kernel then finds no
    # dirty lines of the memset to write back as it reads.
    flush32 = flush.view(torch.int32)
    read_ms = _kernel_ms(flush32.sum)

    def cold(fn):
        return _kernel_ms(lambda: (flush.zero_(), fn())) - flush_ms

    def one():
        return ops.cover_counts(vis, act)

    def multi():
        return ops.cover_counts_multi(vis, act_q)

    def eight():
        return [ops.cover_counts(vis, a) for a in slots]

    err = max(_max_abs_err(one(), ref.cover_counts_ref(vis, act)),
              _max_abs_err(multi(), ref.cover_counts_multi_ref(vis, act_q)),
              _max_abs_err(torch.stack(eight()), multi()))
    _check(err == 0, f"cover_counts differs from its plain version: {err}")
    per = dict(ms=cold(one), warm_ms=_kernel_ms(one),
               eager_cold_ms=_time_ms(one, 50, flush.zero_),
               plain_ms=_time_ms(lambda: ref.cover_counts_ref(vis, act), 10,
                                 flush.zero_),
               flush_ms=flush_ms, max_abs_err=err,
               clean_cold_ms=_kernel_ms(lambda: (flush32.sum(), one()))
               - read_ms)
    multi_per = dict(q=q, ms=cold(multi), warm_ms=_kernel_ms(multi),
                     eight_launches_ms=cold(eight),
                     eight_launches_warm_ms=_kernel_ms(eight),
                     plain_ms=_time_ms(lambda: ref.cover_counts_multi_ref(
                         vis, act_q), 3, flush.zero_))
    # Each visited word read once, the active words once, the counts
    # written once; and, popcount and add per (word, mask).
    for d, masks in ((per, 1), (multi_per, q)):
        bytes_ms = 1e3 * (b * v * w + b * masks * w + masks * v) * 4 \
            / HBM_BYTES_PER_S
        ops_ms = 1e3 * 3 * b * v * w * masks / SCALAR_OPS_PER_S
        d.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    per["multi"] = multi_per
    print(f"[timing] cover_counts (B, V, W)=({b}, {v}, {w}), device time: "
          f"cold {per['ms']:.4f} ms (graph of 10 flush + kernel pairs less "
          f"10 flushes of {flush_ms:.4f} ms each; events around one eager "
          f"call {per['eager_cold_ms']:.4f}; after a flush that reads, "
          f"leaving L2 clean, {per['clean_cold_ms']:.4f}), warm "
          f"{per['warm_ms']:.4f} ms, "
          f"plain {per['plain_ms']:.4f} ms, bound {per['bound_ms']:.4f} ms "
          f"({per['bound_by']})")
    m = multi_per
    print(f"[timing] cover_counts_multi Q {q} (a marginal flush's masks): "
          f"cold {m['ms']:.4f} ms, warm {m['warm_ms']:.4f} ms, against 8 "
          f"Q = 1 launches cold {m['eight_launches_ms']:.4f} ms, warm "
          f"{m['eight_launches_warm_ms']:.4f} ms; Q 8 / Q 1 cold "
          f"{m['ms'] / per['ms']:.2f}; plain {m['plain_ms']:.4f} ms; bound "
          f"{m['bound_ms']:.4f} ms ({m['bound_by']})")
    return per


# ------------------------------------------- fused-versus-unfused phases
def _host_s(fn):
    """(result, seconds) of ``fn()`` on the host clock between two
    synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _spread(times) -> str:
    return (f"{np.median(times) * 1e3:.1f} ms (range "
            f"{min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}, "
            f"{len(times)} run{'s' if len(times) > 1 else ''})")


def _forward_sizes(g, seeds, trials: int, master_seed: int) -> np.ndarray:
    """(trials,) forward IC cascade sizes from the seed set, the rounds of
    ``imm.simulate_influence`` (its mean is that function's value)."""
    from repro_torch.core import bitmask, imm

    seeds = np.asarray(seeds, np.int64)
    sizes, done = [], 0
    while done < trials:
        c = min(256, trials - done)
        fr = bitmask.set_color(
            bitmask.make_mask(g.num_vertices, c, g.device),
            torch.from_numpy(np.repeat(seeds, c)),
            torch.arange(c).repeat(len(seeds)))
        vis = imm._run_from_frontier(g, fr, c, master_seed + done)
        sizes.append(_colour_sizes(vis, c).cpu().numpy())
        done += c
    return np.concatenate(sizes)


def run_unfused_phase(golden: dict) -> dict:
    """9b: the unfused baseline and forward σ(S) at the main configuration
    (module docstring)."""
    from repro_torch.core import bitmask, imm, rrr, traversal
    from repro_torch.graph import csr, generators
    from repro_torch.kernels import ops
    from repro_torch.sampling import SamplerSpec, make_sampler

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gg, gold, b0 = golden["graph"], golden["unfused"], golden["batches"][0]
    g = csr.dedupe(generators.powerlaw_cluster(
        gg["n"], gg["avg_deg"], prob=gg["prob"], seed=gg["seed"]))
    g_rev = csr.transpose(g)
    _check(g.num_edges == gg["num_edges"], "main graph differs")
    n, colors, ms = g.num_vertices, golden["num_colors"], golden["master_seed"]
    starts = rrr.batch_starts(n, colors, ms, 0)
    seed = rrr.batch_seed(ms, 0)

    # (a) the unfused baseline against the fused run and the reference.
    ops.reset_launches()
    vis_u, total = traversal.run_unfused(g_rev, starts, colors, seed)
    fused = traversal.run_fused(g_rev, starts, colors, seed)
    fused_visits = int(fused.stats.fused_edge_visits.astype(np.int64).sum())
    unfused_visits = int(fused.stats.unfused_edge_visits.astype(np.int64)
                         .sum())
    _check(_sha(vis_u) == gold["visited_sha256"] == b0["visited_sha256"]
           and torch.equal(vis_u, fused.visited),
           "run_unfused's mask differs from run_fused's or the reference's")
    _check(total == gold["total_edge_visits"] == b0["unfused_edge_visits"]
           == unfused_visits,
           f"run_unfused visited {total} edges; fused unfused count "
           f"{unfused_visits}, reference {b0['unfused_edge_visits']}")
    levels = []
    for c, gc in enumerate(gold["colors"]):
        r = traversal.run_single_color(g_rev, int(starts[c]), c, seed)
        got = (r.stats.levels_run, int(bitmask.popcount(r.visited).sum()),
               int(r.stats.fused_edge_visits.astype(np.int64).sum()))
        _check(got == (gc["levels_run"], gc["popcount"], gc["edge_visits"]),
               f"colour {c}: (levels, popcount, visits) {got} != reference "
               f"{gc}")
        levels.append(r.stats.levels_run)
    _check(max(levels) == fused.stats.levels_run,
           "the fused run's levels are not the slowest colour's")

    # (b) forward σ(S) of the golden seeds, exactly the reference's.
    sig = gold["sigma"]
    sigma = imm.simulate_influence(g, sig["seeds"], sig["num_trials"],
                                   sig["master_seed"])
    _check(sigma == sig["value"],
           f"simulate_influence {sigma!r} != reference {sig['value']!r}")
    launches = dict(ops.LAUNCHES)
    _check(not any(launches.values()),
           f"the CSR and forward paths launched a kernel: {launches}")

    # (c) forward σ against the reverse estimate on fresh RRR sets (kernel
    # backend), and the greedy seeds against random ones.
    sizes = _forward_sizes(g, sig["seeds"], SIGMA_TRIALS, SIGMA_MASTER_SEED)
    _check(sizes.sum() / SIGMA_TRIALS == sigma,
           "per-trial cascade sizes do not sum to simulate_influence's σ")
    rand = np.random.default_rng(0).integers(0, n, len(sig["seeds"]))
    sizes_r = _forward_sizes(g, rand, SIGMA_TRIALS, SIGMA_MASTER_SEED)
    ops.reset_launches()
    fresh = rrr.sample_collection(
        g, FRESH_THETA, colors, FRESH_SEED, spec=SamplerSpec(
            backend="kernel", num_colors=colors, master_seed=FRESH_SEED))
    _check(ops.LAUNCHES["fused_expand"] > 0,
           "sample_collection on the kernel backend never launched "
           "fused_expand")
    cov = imm.coverage_of(torch.stack([b.visited for b in fresh]),
                          sig["seeds"], colors)
    del fresh
    rev = n * cov
    se_rev = n * np.sqrt(cov * (1 - cov) / FRESH_THETA)
    se_fwd = float(sizes.std(ddof=1)) / np.sqrt(SIGMA_TRIALS)
    se = float(np.hypot(se_rev, se_fwd))
    _check(abs(rev - sigma) <= SIGMA_SE * se,
           f"forward σ {sigma} and reverse n·coverage {rev:.1f} differ by "
           f"more than {SIGMA_SE} × {se:.1f}")
    sigma_r = float(sizes_r.mean())
    _check(sigma > sigma_r, f"greedy σ {sigma} ≤ random σ {sigma_r}")

    # (d) host clock, in turns: fused CSR, unfused CSR, the kernel backend.
    kern = make_sampler(g, SamplerSpec(backend="kernel"), g_rev=g_rev)
    runs = {"fused": lambda: traversal.run_fused(g_rev, starts, colors, seed),
            "unfused": lambda: traversal.run_unfused(g_rev, starts, colors,
                                                     seed),
            "kernel": lambda: kern.sample(0)}
    times = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            out, sec = _host_s(fn)
            times[k].append(sec)
    _check(_sha(out.visited) == b0["visited_sha256"],
           "kernel batch 0 differs from the reference")
    lv = fused.stats.levels_run
    occ = float(fused.stats.occupancy_num[:lv].mean())
    ratio = float(np.median(times["unfused"]) / np.median(times["fused"]))
    res = dict(
        fused_ms=float(np.median(times["fused"])) * 1e3,
        unfused_ms=float(np.median(times["unfused"])) * 1e3,
        kernel_ms=float(np.median(times["kernel"])) * 1e3,
        unfused_over_fused=ratio, fused_visits=fused_visits,
        unfused_visits=unfused_visits,
        savings=1 - fused_visits / unfused_visits, levels=lv,
        colour_levels=(min(levels), float(np.mean(levels)), max(levels)),
        occupancy=occ, sigma=sigma, sigma_random=sigma_r, reverse=rev,
        se=se, peak_gib=_peak_gib(), seconds=time.perf_counter() - t_phase)
    print(f"[unfused a] run_unfused (64 single-colour runs) on batch 0: mask "
          f"equals run_fused's and the reference's word for word; "
          f"{total} edge visits = the reference's; each colour's levels "
          f"and popcount equal the reference's (levels min/mean/max "
          f"{min(levels)}/{np.mean(levels):.2f}/{max(levels)}; fused "
          f"{lv}); no kernel launched")
    print(f"[unfused b] simulate_influence(top-16 seeds[:8], "
          f"{SIGMA_TRIALS}) = {sigma!r}, the reference's exactly")
    print(f"[unfused c] forward σ {sigma:.3f} ± {se_fwd:.3f} against "
          f"n·coverage {rev:.3f} ± {se_rev:.3f} on {FRESH_THETA} fresh RRR "
          f"sets (kernel backend, master_seed {FRESH_SEED}): |difference| "
          f"{abs(rev - sigma):.3f} ≤ {SIGMA_SE} × {se:.3f}; random 8 "
          f"vertices σ {sigma_r:.3f}, greedy/random {sigma / sigma_r:.2f}×")
    print(f"[unfused d] batch 0, host clock after synchronise: run_fused "
          f"(CSR) {_spread(times['fused'])}, run_unfused (CSR) "
          f"{_spread(times['unfused'])}, kernel backend "
          f"{_spread(times['kernel'])}; unfused/fused {ratio:.2f}×; edge "
          f"visits fused {fused_visits}, unfused {unfused_visits}, savings "
          f"{100 * res['savings']:.2f}%; {lv} levels, mean occupancy "
          f"{occ:.4f}; peak device memory {res['peak_gib']:.2f} GiB; "
          f"{res['seconds']:.1f}s")
    return res


def run_table1_grid() -> dict:
    """9c: the paper's Fig. 7/8 grid at web-Google's size (module
    docstring); every point's Theorem 1 coupling is checked exactly."""
    from repro_torch.core import traversal
    from repro_torch.graph import csr, datasets, generators

    t_phase = time.perf_counter()
    v, _, deg = datasets.TABLE1[T1_NAME]
    t0 = time.perf_counter()
    base = csr.transpose(generators.powerlaw_cluster(v, deg,
                                                     seed=T1_GRAPH_SEED))
    src, dst, _ = base.edges_numpy()
    e = base.num_edges
    del base
    print(f"[table1] {T1_NAME}'s size: powerlaw_cluster({v}, {deg}, seed "
          f"{T1_GRAPH_SEED}), reversed: {e} edges, built in "
          f"{time.perf_counter() - t0:.1f}s")
    points = []
    for p in T1_PROBS:
        g = csr.from_edges(src, dst, np.full(e, p, np.float32), v)
        for c in T1_COLORS:
            starts = traversal.random_starts(0, v, c)
            torch.cuda.reset_peak_memory_stats()
            t_f = []
            for _ in range(3):
                fused, sec = _host_s(lambda: traversal.run_fused(
                    g, starts, c, T1_SEED))
                t_f.append(sec)
            t_u = []
            while len(t_u) < 3 and sum(t_u) < UNFUSED_BUDGET_S:
                (vis, total), sec = _host_s(lambda: traversal.run_unfused(
                    g, starts, c, T1_SEED))
                t_u.append(sec)
            fv = int(fused.stats.fused_edge_visits.astype(np.int64).sum())
            uv = int(fused.stats.unfused_edge_visits.astype(np.int64).sum())
            _check(torch.equal(vis, fused.visited) and total == uv,
                   f"p {p}, {c} colours: run_unfused differs from run_fused "
                   f"(visits {total} vs {uv})")
            _check(fv <= uv, f"Theorem 1 fails at p {p}, {c} colours")
            lv = fused.stats.levels_run
            pt = dict(p=p, colors=c, fused_ms=float(np.median(t_f)) * 1e3,
                      unfused_ms=float(np.median(t_u)) * 1e3,
                      unfused_runs=len(t_u), fused_visits=fv,
                      unfused_visits=uv, levels=lv,
                      occupancy=float(fused.stats.occupancy_num[:lv].mean())
                      if lv else 0.0, peak_gib=_peak_gib())
            pt["speedup"] = pt["unfused_ms"] / pt["fused_ms"]
            points.append(pt)
            print(f"[table1] p {p} colours {c}: fused {_spread(t_f)}, "
                  f"unfused {_spread(t_u)}; speedup {pt['speedup']:.2f}×; "
                  f"visits fused/unfused {fv}/{uv} = "
                  f"{fv / max(uv, 1):.4f}; {lv} levels, occupancy "
                  f"{pt['occupancy']:.4f}; masks and totals equal; peak "
                  f"device memory {pt['peak_gib']:.2f} GiB")
        del g
    seconds = time.perf_counter() - t_phase
    print(f"[table1] 3 × 3 grid: run_unfused ≡ run_fused word for word and "
          f"in total visits at every point; {seconds:.1f}s")
    return dict(points=points, seconds=seconds)


# ----------------------------------------------------------- quantised phases
def _ranks(results, key):
    return [r[key] for r in results]


def check_mesh_front_end(a4: list) -> dict:
    """(f)'s checks and its ``[mesh async]`` lines, from the 2x2 ranks'
    results: every served answer equals the engine's own, asked directly
    after ``STOP`` on every rank at the answer's pool version, and the
    one-device engine's on the final pool; the deadline and refresh
    contract; the kernels launched on every rank; the followers made the
    leader's calls in its order.  Returns the numbers the result lines and
    the ``kernels`` line carry."""
    from repro_torch.launch import mesh_smoke

    fs = _ranks(a4, "f")
    lead = fs[0]
    st = lead["stats"]
    answers = lead["answers"]
    served = [("lone", None) + answers["lone"]] + [
        ("clients", i) + a for i, a in enumerate(answers["clients"])] + [
        ("top_k", None) + answers["top_k"],
        ("marginal", None) + answers["marginal"]]
    for kind, i, value, version in served:
        for f in fs:
            direct = f["direct"].get(version)
            _check(direct is not None and (
                direct[kind] if i is None else direct[kind][i]) == value,
                f"[mesh async] the {kind} answer {value} (pool version "
                f"{version}) differs from rank {fs.index(f)}'s direct one")
    final = lead["direct"][lead["version"]]
    one = lead["one_device"]["answers"]
    _check(one == final, "[mesh async] the one-device engine on the final "
           f"pool answers differently: {one['top_k']} vs {final['top_k']}")
    _check(lead["lone_deadline_flushes"] >= 1,
           f"[mesh async] the lone request did not flush on its deadline: "
           f"{st}")
    _check(st["max_queue_wait"] <= mesh_smoke.FE_DEADLINE_S + 0.25,
           f"[mesh async] a request waited past its deadline: {st}")
    _check(st["refreshes"] >= 1 and all(
        f["version"] == lead["version"] and f["version"][1] >= 1
        for f in fs), f"[mesh async] no refresh, or the ranks' pool "
        f"versions differ: {[f['version'] for f in fs]}")
    _check(lead["version_later"] == lead["version_closed"],
           "[mesh async] the pool version moved after close()")
    _check(all(f["launches"][k] > 0 for f in fs for k in (
        "cover_counts", "cover_counts_multi", "fused_expand")),
        f"[mesh async] a rank never launched cover_counts, "
        f"cover_counts_multi or fused_expand: {[f['launches'] for f in fs]}")
    ops_of = [[op for op, _ in f["dispatches"]] for f in fs]
    _check(all(o == ops_of[0] for o in ops_of) and all(
        f["messages"] == lead["messages"] for f in fs),
        "[mesh async] the followers' calls differ from the leader's")
    worst = [max(f["dispatches"][j][1] for f in fs)
             for j in range(len(ops_of[0]))]
    mesh_ms = {op: 1e3 * float(np.median(
        [t for o, t in zip(ops_of[0], worst) if o == op]))
        for op in sorted(set(ops_of[0]))}
    one_ms = lead["one_device"]["ms"]
    out = dict(launches={k: sum(f["launches"][k] for f in fs) for k in (
        "fused_expand", "cover_counts", "cover_counts_multi")},
        mesh_ms=mesh_ms, one_ms=one_ms,
        broadcast_ms=max(f["broadcast_ms"] for f in fs),
        seconds=max(f["seconds"] for f in fs), messages=lead["messages"])
    print(f"[mesh async] graph_parallel IC on 2x2 over (a)'s 64-batch pool: "
          f"rank 0 leads ({st['flushes']} flushes: {st['slot_flushes']} "
          f"slot / {st['deadline_flushes']} deadline / "
          f"{st['drain_flushes']} drain; {st['served']} served; "
          f"{st['refreshes']} background refresh(es), epoch "
          f"{lead['version'][1]}), 3 ranks follow; messages "
          f"{lead['messages']} of {lead['message_bytes']} bytes; every "
          f"answer equals the engine's direct one on every rank and the "
          f"one-device engine's; worst queue wait "
          f"{st['max_queue_wait'] * 1e3:.1f} ms (deadline "
          f"{mesh_smoke.FE_DEADLINE_S * 1e3:.0f} ms); launches by rank "
          + ", ".join(f"{k} {[f['launches'][k] for f in fs]}" for k in (
              "fused_expand", "cover_counts", "cover_counts_multi")))
    print(f"[mesh async] flush ms, host clock from dispatch start to "
          f"results (worst rank, median over the session's dispatches) "
          f"against one device on the final pool (mean of 3): "
          + ", ".join(f"{op} {mesh_ms[op]:.3f}"
                      + (f" vs {one_ms[op]:.3f}" if op in one_ms else "")
                      for op in mesh_ms)
          + f"; the whole-mesh broadcast of one message alone "
          f"{out['broadcast_ms']:.3f} ms (worst rank, mean of 20); "
          f"{out['seconds']:.2f}s of session, collectives by axis "
          f"{lead['collectives']}")
    return out


def check_mesh_results(a4: list, b3: list, d1: list,
                       single_build_s: dict) -> dict:
    """Phase 9d's checks and lines, from the ranks' results
    (`repro_torch.launch.mesh_smoke`); returns the numbers the result
    lines and the ``kernels`` line carry."""
    out = {"f": check_mesh_front_end(a4)}
    for tag, sub, kernel in (("a", "IC", "fused_expand"),
                             ("b", "LT", "lt_select_expand")):
        rs = _ranks(a4, tag)
        _check(all(r["shas_equal"] for r in rs),
               f"[mesh {tag}] batches 0-3 differ from the golden file")
        _check(all(r["top_equal"] for r in rs),
               f"[mesh {tag}] top-16 differs from the golden file")
        _check(all(r["sparse_equals_dense"] for r in rs),
               f"[mesh {tag}] sparse-leg pool differs from the dense leg's")
        _check(all(r["launches"][kernel] > 0
                   and r["launches"]["cover_counts"] > 0 for r in rs),
               f"[mesh {tag}] a rank never launched {kernel} or "
               f"cover_counts: {[r['launches'] for r in rs]}")
        _check(all(r["check"]["max_abs_err"] == 0 for r in rs),
               f"[mesh {tag}] {kernel} differs from its plain version")
        _check(all(r["cover_check"]["max_abs_err"] == 0 for r in rs),
               f"[mesh {tag}] cover_counts or cover_counts_multi differs "
               f"from its plain version on a rank's block: "
               f"{[r['cover_check'] for r in rs]}")
        _check(all(r["words_dense"] == rs[0]["words_dense"]
                   and r["words_sparse"] == rs[0]["words_sparse"]
                   for r in rs), f"[mesh {tag}] ranks disagree on words")
        r0 = rs[0]
        print(f"[mesh {tag}] graph_parallel {sub} on 2x2 ({a4[0]['backend']} "
              f"transport, every rank on {a4[0]['device']}): batches 0-3 "
              f"equal the golden sha256s and top-16 {r0['seeds'][:4]}... "
              f"(σ̂ {r0['sigma']:.1f}) on every rank; 64-batch pool "
              f"{max(r['build_dense_s'] for r in rs):.3f}s on the dense "
              f"leg, {max(r['build_sparse_s'] for r in rs):.3f}s on the "
              f"sparse leg (auto capacity), masks equal, beside "
              f"{single_build_s[tag]:.3f}s on one device (phase "
              f"{'4' if tag == 'a' else '7'}); {sub} levels per batch "
              f"{sorted(set(r0['levels_dense']))}")
        print(f"[mesh {tag}] gather_words per level, dense leg "
              f"{r0['words_dense'][:8]}... ({sum(r0['words_dense'])} in "
              f"all), sparse leg {r0['words_sparse'][:8]}... "
              f"({sum(r0['words_sparse'])})")
        print(f"[mesh {tag}] every level of batch 0 on each rank's slot "
              f"list ({[r['check']['entries'] for r in rs]} entries, rows "
              f"{[r['check']['row_base'] for r in rs]} + "
              f"{r0['check']['rows']}, {r0['check']['levels']} levels): "
              f"{kernel} equals its plain version bit for bit; launches by "
              f"rank {kernel} {[r['launches'][kernel] for r in rs]}, "
              f"cover_counts {[r['launches']['cover_counts'] for r in rs]}")
        print(f"[mesh {tag}] cover_counts and cover_counts_multi "
              f"({r0['cover_check']['queries']} queries) on each rank's "
              f"{r0['cover_check']['shape']} block of the 64-batch pool "
              f"equal their plain versions")
        print(f"[mesh {tag}] {max(r['seconds'] for r in rs):.2f}s, peak "
              f"{[round(r['peak_gib'], 3) for r in rs]} GiB per rank, "
              f"staged {[r['staged_bytes'] for r in rs]} bytes per rank, "
              f"collectives by axis {r0['collectives']}")
        out[tag] = dict(
            launches={k: sum(r["launches"][k] for r in rs)
                      for k in (kernel, "cover_counts")},
            max_abs_err=max(r["check"]["max_abs_err"] for r in rs),
            cover_max_abs_err=max(r["cover_check"]["max_abs_err"]
                                  for r in rs),
            build_dense_s=max(r["build_dense_s"] for r in rs),
            build_sparse_s=max(r["build_sparse_s"] for r in rs),
            seconds=max(r["seconds"] for r in rs),
            peak_gib=max(r["peak_gib"] for r in rs),
            staged_bytes=max(r["staged_bytes"] for r in rs),
            words_dense=sum(r0["words_dense"]),
            words_sparse=sum(r0["words_sparse"]))
    ex = _ranks(a4, "exchange")
    out["exchange"] = {k: max(e[k] for e in ex)
                       for k in ("dense_ms", "butterfly_ms", "pmax_ms")}
    print(f"[mesh exchange] one level's exchange alone on 2x2, host clock "
          f"after synchronise (worst rank): all-gather of a "
          f"({a4[0]['a']['check']['rows']}, 2) frontier "
          f"({ex[0]['dense_bytes']} bytes a rank) "
          f"{out['exchange']['dense_ms']:.3f} ms, butterfly of "
          f"{ex[0]['tail_words']} live words "
          f"{out['exchange']['butterfly_ms']:.3f} ms, the control pmax "
          f"{out['exchange']['pmax_ms']:.3f} ms")
    cs = _ranks(a4, "c")
    _check(all(c["shas_equal"] and c["top_equal"] for c in cs),
           "[mesh c] data_parallel batches or top-16 differ from golden")
    _check(all(c["restore_equal"] for c in cs),
           "[mesh c] (a)'s snapshot restored onto 4x1 answers differently")
    _check(all(c["refresh_equal"] for c in cs),
           "[mesh c] refresh differs from the one-device pool's")
    _check(all(c["launches"]["cover_counts"] > 0 for c in cs),
           "[mesh c] a rank never launched cover_counts")
    _check(all(c["cover_check"]["max_abs_err"] == 0 for c in cs),
           "[mesh c] cover_counts or cover_counts_multi differs from its "
           "plain version on a rank's block: "
           f"{[c['cover_check'] for c in cs]}")
    print(f"[mesh c] data_parallel IC on 4x1 ({a4[0]['backend']} "
          f"transport): batches 0-3 and top-16 equal "
          f"the golden file; (a)'s 64-batch snapshot restored onto 4x1 "
          f"answers top-16 the same; refresh(0.5) slots "
          f"{cs[0]['refresh_slots']} and answers equal a one-device pool's; "
          f"cover_counts and cover_counts_multi on each rank's "
          f"{cs[0]['cover_check']['shape']} block equal their plain "
          f"versions; "
          f"{max(c['seconds'] for c in cs):.2f}s, peak "
          f"{[round(c['peak_gib'], 3) for c in cs]} GiB, staged "
          f"{[c['staged_bytes'] for c in cs]} bytes per rank")
    out["c"] = dict(launches={"cover_counts": sum(
        c["launches"]["cover_counts"] for c in cs)},
        seconds=max(c["seconds"] for c in cs),
        cover_max_abs_err=max(c["cover_check"]["max_abs_err"] for c in cs))
    d = d1[0]
    _check(d["backend"] == "nccl" and d["shas_equal"] and d["top_equal"],
           "[mesh d] the 1x1 NCCL mesh differs from the golden file")
    _check(d["restore_equal"], "[mesh d] (a)'s snapshot restored onto 1x1 "
           "answers differently")
    _check(d["launches"]["fused_expand"] > 0, "[mesh d] no fused_expand")
    _check(d["cover_check"]["max_abs_err"] == 0,
           "[mesh d] cover_counts or cover_counts_multi differs from its "
           f"plain version: {d['cover_check']}")
    print(f"[mesh d] 1x1 mesh, {d['backend']} transport: batches 0-3 and "
          f"top-16 equal the golden file; (a)'s snapshot restored onto 1x1 "
          f"answers the same; launches {d['launches']['fused_expand']} "
          f"fused_expand, {d['launches']['cover_counts']} cover_counts; "
          f"{d['seconds']:.2f}s, peak {d['peak_gib']:.3f} GiB, staged "
          f"{d['staged_bytes']} bytes")
    out["d"] = dict(launches={k: d["launches"][k]
                              for k in ("fused_expand", "cover_counts")},
                    seconds=d["seconds"],
                    cover_max_abs_err=d["cover_check"]["max_abs_err"])
    es = _ranks(a4, "e") + _ranks(b3, "e")
    cases = [c for e in es for c in e["cases"]]
    _check(len(cases) == 4 * 4 + 4 * 3 and all(
        c["shas_equal"] and c["words_equal"] for c in cases),
        "[mesh e] a case differs from the golden \"mesh\" entry: "
        + str([c for c in cases if not (c["shas_equal"]
                                        and c["words_equal"])]))
    print(f"[mesh e] reduced golden (4,096 vertices, batches 0-7): IC and "
          f"LT, dense and sparse leg, on 2x2 and 1x3: every sha256 and "
          f"every level's gather_words equal the reference on every rank "
          f"({sum(c['words'] for c in cases[:4])} words on 2x2 rank 0); "
          f"{', '.join(e['backend'] for e in es[:1])} transport; "
          f"{max(e['seconds'] for e in es):.2f}s, peak "
          f"{[round(e['peak_gib'], 3) for e in es]} GiB, staged "
          f"{[e['staged_bytes'] for e in es]} bytes per rank (2x2, then 1x3)")
    return out


def run_mesh_phase(golden: dict, single_build_s: dict) -> dict:
    """Phase 9d: the mesh paths at the main configuration on one card —
    a 2x2 gloo world of 4 ranks ((a), (b), (c) on its 4x1 mesh, (e)), a
    1x3 world ((e)), and a 1x1 NCCL world ((d)).  A rank that fails fails
    the phase."""
    import shutil
    import tempfile

    from repro_torch.launch import accel, mesh_smoke

    ckpt = tempfile.mkdtemp(prefix="mesh_pool_")
    t0 = time.perf_counter()
    try:
        a4 = accel.spawn(mesh_smoke.rank_main_2x2, 4, args=(golden, ckpt),
                         backend="gloo", device="cuda", timeout_s=420)
        t_a = time.perf_counter() - t0
        b3 = accel.spawn(mesh_smoke.rank_main_1x3, 3, args=(golden,),
                         backend="gloo", device="cuda", timeout_s=240)
        t_b = time.perf_counter() - t0 - t_a
        d1 = accel.spawn(mesh_smoke.rank_main_1x1, 1,
                         args=(golden, ckpt, a4[0]["a"]["snapshot_top"]),
                         backend="nccl", device="cuda", timeout_s=240)
        t_d = time.perf_counter() - t0 - t_a - t_b
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[mesh] worlds on {torch.cuda.get_device_name(0)}: 2x2 gloo (4 "
          f"ranks) {t_a:.1f}s, 1x3 gloo {t_b:.1f}s, 1x1 nccl {t_d:.1f}s "
          f"of host clock, each with its ranks' start")
    out = check_mesh_results(a4, b3, d1, single_build_s)
    out["seconds"] = dict(world_2x2=t_a, world_1x3=t_b, world_1x1=t_d)
    return out


def _q_graph(n: int, dev):
    """The quantised path's graph: powerlaw_cluster(n, 6.0, p = 0.25, seed
    7), deduped, ``cluster`` order, reversed; its quantised layout.  Returns
    (reversed graph, tg, q8, host seconds of the reordering)."""
    from repro_torch.core import tiles
    from repro_torch.graph import csr, generators, reorder

    g = csr.dedupe(generators.powerlaw_cluster(n, Q_DEGREE, prob=Q_PROB,
                                               seed=Q_GRAPH_SEED, device=dev))
    t0 = time.perf_counter()
    g_ord, _ = reorder.apply(g, "cluster")
    reorder_s = time.perf_counter() - t0
    g_rev = csr.transpose(g_ord)
    tg, q8 = tiles.quantized(g_rev)
    return g_rev, tg, q8, reorder_s


def _colour_sizes(visited: torch.Tensor, colors: int) -> torch.Tensor:
    """(colors,) float64 RRR set sizes: the vertices carrying each colour."""
    from repro_torch.core import bitmask
    return bitmask.unpack_bits(visited).sum(0).reshape(-1)[:colors].double()


def check_q_golden(golden: dict, dev) -> None:
    """The port's whole quantised path at the golden file's ``"q"`` size
    (generator, ``cluster``, q8 layout, ``run_fused_q_tiled`` on the dense
    grid and the compacted list) against the reference's ``graph_q`` loop,
    bit for bit."""
    from repro_torch.core import rrr, tiled_traversal

    gold = golden["q"]
    spec = gold["graph"]
    g_rev, tg, q8, _ = _q_graph(spec["n"], dev)
    _check((g_rev.num_edges, tg.num_tiles) == (spec["num_edges"],
                                               spec["num_tiles"]),
           "q golden: graph or tile layout differs from the reference")
    for frontier in ("dense", "sparse"):
        for gb in gold["batches"]:
            b = gb["batch_index"]
            vis, levels, _ = tiled_traversal.run_fused_q_tiled(
                tg, q8, rrr.batch_starts(spec["n"], gold["num_colors"],
                                         gold["master_seed"], b),
                gold["num_colors"], rrr.batch_seed(gold["master_seed"], b),
                frontier=frontier)
            bits = int(_colour_sizes(vis, gold["num_colors"]).sum())
            _check(levels == gb["levels"] and bits == gb["visited_bits"]
                   and _sha(vis) == gb["visited_sha256"],
                   f"q golden: {frontier} batch {b} differs from the "
                   f"reference ({levels} levels, {bits} bits)")
    print(f"[q golden] n {spec['n']}, cluster order, {tg.num_tiles} tiles: "
          f"batches {[gb['batch_index'] for gb in gold['batches']]} on the "
          "dense grid and the compacted list equal the reference's graph_q "
          "loop bit for bit (levels "
          f"{[gb['levels'] for gb in gold['batches']]})")


def check_q_kernel_full(tg, q8, dev) -> dict:
    """The kernel against its plain version on the main graph: a list of
    Q_CHECK_TILES tile ids spread evenly over the id range (a quarter or
    more past 2¹⁸, where the cell id wraps), two frontier densities; the
    plain version's time on that list."""
    from repro_torch.kernels import ops, ref

    nt = tg.num_tiles
    ids = torch.unique(torch.linspace(0, nt - 1, Q_CHECK_TILES, device=dev)
                       .round().long()).int()
    wrap = int((ids >= 2 ** 32 // tg.tile_size ** 2).sum())
    _check(ids.numel() == Q_CHECK_TILES and 4 * wrap >= ids.numel(),
           f"q check list: {ids.numel()} ids, {wrap} past the wrap")
    gen = torch.Generator(device=dev).manual_seed(1)
    err, plain_ms = 0, []
    for density, level in ((0.02, 3), (0.3, 40)):
        fr, vis = _random_masks(tg.padded_vertices, 64, density, gen, dev)
        got = ops.fused_expand_q(tg, q8, fr, vis, 0xDEADBEEF, level,
                                 tile_ids=ids)
        want = [None]

        def plain():
            want[0] = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst,
                                             fr, vis, 0xDEADBEEF, level,
                                             tile_ids=ids)
        plain_ms.append(_time_ms(plain, 3))
        _check(bool(want[0].any()), "q check list reached nothing")
        err = max(err, _max_abs_err(got, want[0]))
    _check(err == 0, f"fused_expand_q differs from its plain version on the "
           f"main graph's list: max word diff {err}")
    print(f"[q kernels] fused_expand_q on {ids.numel()} tile ids spread over "
          f"0..{nt - 1} ({wrap} of them ≥ {2 ** 32 // tg.tile_size ** 2}, "
          f"where the cell id wraps), frontier densities 0.02 and 0.3: max "
          f"word diff {err}; plain version {plain_ms[0]:.4f} / "
          f"{plain_ms[1]:.4f} ms")
    return dict(max_abs_err=err, plain_ms=float(np.mean(plain_ms)))


def run_q_main_path(tg, q8, g_rev) -> dict:
    """The main path: Q_BATCHES batches of 64 colours through
    ``run_fused_q_tiled`` on the dense grid and on the compacted list (in
    turns), launch counters zeroed just before and read just after; the
    two grids must give identical words."""
    from repro_torch.core import rrr, tiled_traversal
    from repro_torch.kernels import ops

    n = g_rev.num_vertices
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = {"dense": [], "sparse": []}
    for b in range(Q_BATCHES):
        starts, seed = rrr.batch_starts(n, 64, 0, b), rrr.batch_seed(0, b)
        for frontier in (("dense", "sparse") if b % 2 == 0
                         else ("sparse", "dense")):
            work = {}
            t0 = time.perf_counter()
            vis, levels, _ = tiled_traversal.run_fused_q_tiled(
                tg, q8, starts, 64, seed, frontier=frontier, work=work)
            torch.cuda.synchronize()
            out[frontier].append(dict(vis=vis, levels=levels,
                                      ms=1e3 * (time.perf_counter() - t0),
                                      tiles=work["active_tiles"]))
    launches = dict(ops.LAUNCHES)
    levels = [r["levels"] for r in out["dense"]]
    for d, c in zip(out["dense"], out["sparse"]):
        _check(d["levels"] == c["levels"] and torch.equal(d["vis"], c["vis"]),
               "q main path: the compacted list differs from the dense grid")
    _check(launches["fused_expand_q"] == 2 * sum(levels),
           f"q main path: fused_expand_q launched "
           f"{launches['fused_expand_q']} times, not {2 * sum(levels)}")
    sizes = torch.cat([_colour_sizes(r["vis"], 64) for r in out["dense"]])
    per = dict(launches=launches, levels=levels, sizes=sizes,
               batch_dense_ms=float(np.mean([r["ms"] for r in out["dense"]])),
               batch_compact_ms=float(np.mean([r["ms"]
                                               for r in out["sparse"]])),
               batch0_ms={f: out[f][0]["ms"] for f in out},
               peak_gib=_peak_gib())
    print(f"[q main] {Q_BATCHES} batches × 64 colours on the dense grid and "
          f"the compacted list: identical words; levels per batch {levels}; "
          f"launches {launches}; end to end per batch: dense grid "
          f"{per['batch_dense_ms']:.2f} ms "
          f"{[round(r['ms'], 2) for r in out['dense']]}, compacted list "
          f"{per['batch_compact_ms']:.2f} ms "
          f"{[round(r['ms'], 2) for r in out['sparse']]}; mean RRR set "
          f"{float(sizes.mean()):.1f} vertices; peak device memory "
          f"{per['peak_gib']:.2f} GiB")
    print(f"[q main] batch 0, tiles walked per level on the compacted list: "
          f"{out['sparse'][0]['tiles']}")
    return per


def time_q_kernel(tg, q8, g_rev) -> dict:
    """Every level of batch 0 through ``fused_expand_q_cuda`` on the dense
    grid and on the level's compacted list (device time per launch,
    `_kernel_ms`), and the compaction (CUDA events), as `time_tile_kernel`
    does; the slot list read back from the stack (timed), equal to the one
    `tiles.quantized` built.  Each level's bound counts what its data
    needs: the q byte of every edge whose source row is live; the output
    mask; the run pointers; on the dense grid the whole frontier and
    visited masks and every tile's
    source block, on the list the frontier rows of the listed tiles' source
    blocks, the visited rows of their destination blocks and each entry's
    id and source block.  Operations: one cell fold per live edge
    (OPS_PER_EDGE_FOLD) and one hash and byte compare per live nibble
    (OPS_PER_Q_HASH): four colours of the source row not all visited at
    the destination."""
    from repro_torch.core import bitmask, rrr, sparse, tiles, traversal
    from repro_torch.kernels.fused_expand_q import fused_expand_q_cuda

    n, dev = g_rev.num_vertices, tg.device
    seed = rrr.batch_seed(0, 0)
    fr = tiles.pad_mask_rows(traversal.init_frontier(
        n, 64, rrr.batch_starts(n, 64, 0, 0), dev), tg.padded_vertices)
    vis = torch.zeros_like(fr)

    slots = tiles.q_slot_list(tg, q8)
    t0 = time.perf_counter()
    again = tiles.q_slot_list_from_stack(tg, q8)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    _check(_same_lists(again, slots), "fused_expand_q: the slot list read "
           "from the stack differs from the layout's")
    del again
    print(f"[q timing] slot list: {slots.num_entries} entries "
          f"({slots.nbytes / 2 ** 20:.2f} MiB) built with the layout from "
          f"its host arrays; read back from the {q8.numel() / 2 ** 30:.2f} "
          f"GiB stack in {build_ms:.1f} ms, equal")

    def kernel(level, fr, vis, ids):
        return fused_expand_q_cuda(slots, fr, vis, seed, level, tile_ids=ids)

    def compact(fr):
        return tiles.active_tile_ids(
            tg.tile_src, sparse.row_block_activity(fr, tg.tile_size))

    src = g_rev.src[:g_rev.num_edges].long()
    dst = g_rev.dst[:g_rev.num_edges].long()
    row_bytes = tg.tile_size * fr.shape[1] * 4
    ptr_bytes = (tg.num_blocks + 1) * 4
    nibble = torch.arange(8, device=dev) * 4
    t = {k: [] for k in ("dense", "compact", "compaction", "bytes_dense",
                         "bytes_compact", "ops", "tiles", "bytes_rows")}
    levels, err = [], 0
    while len(levels) < 64 and bitmask.any_set(fr):
        level = len(levels)
        vis = vis | fr
        ids = compact(fr)
        t["compaction"].append(_time_ms(lambda: compact(fr), 3))
        nf = kernel(level, fr, vis, None)
        err = max(err, _max_abs_err(kernel(level, fr, vis, ids), nf))
        fr_src = fr[src]
        live = (fr_src != 0).any(1)
        pend = bitmask.u32(fr_src[live] & ~vis[dst[live]])
        nibbles = int(((pend[..., None] >> nibble) & 0xF).ne(0).sum())
        n_live = int(live.sum())
        out_bytes = fr.numel() * 4
        listed = ids.long()
        n_src = int(torch.unique(tg.tile_src[listed]).numel())
        n_dst = int(torch.unique(tg.tile_dst[listed]).numel())
        t["bytes_dense"].append(n_live + 3 * out_bytes + tg.num_tiles * 4
                                + ptr_bytes)
        t["bytes_compact"].append(n_live + out_bytes
                                  + (n_src + n_dst) * row_bytes
                                  + ids.numel() * 8 + ptr_bytes)
        t["ops"].append(n_live * OPS_PER_EDGE_FOLD + nibbles * OPS_PER_Q_HASH)
        t["tiles"].append(int(ids.numel()))
        # Not the bound: the q rows the walk reads, T bytes per live source
        # row of every walked tile (the layout has no index of its edges).
        rows = (fr != 0).any(1).view(-1, tg.tile_size).sum(1)
        t["bytes_rows"].append(int(rows[tg.tile_src.long()].sum())
                               * tg.tile_size)
        levels.append((fr, vis, ids))
        fr = nf
    for level, (fr, vis, ids) in enumerate(levels):
        t["dense"].append(_kernel_ms(lambda: kernel(level, fr, vis, None)))
        t["compact"].append(_kernel_ms(lambda: kernel(level, fr, vis, ids)))
    n_levels = len(levels)
    del levels
    _check(err == 0, f"fused_expand_q: compacted list differs from the dense "
           f"grid at full size: max word diff {err}")
    ops_s = np.asarray(t["ops"]) / SCALAR_OPS_PER_S
    per = dict(levels=n_levels, max_abs_err=err,
               compaction_ms=float(np.mean(t["compaction"])),
               tiles=float(np.mean(t["tiles"])),
               slot_entries=slots.num_entries, slot_bytes=slots.nbytes,
               slot_build_ms=build_ms)
    for grid in ("dense", "compact"):
        bytes_s = np.asarray(t[f"bytes_{grid}"]) / HBM_BYTES_PER_S
        per[f"{grid}_ms"] = float(np.mean(t[grid]))
        per[f"{grid}_bytes_ms"] = float(1e3 * np.mean(bytes_s))
        per[f"{grid}_ops_ms"] = float(1e3 * np.mean(ops_s))
        per[f"{grid}_bound_ms"] = float(np.mean(1e3 * np.maximum(bytes_s,
                                                                 ops_s)))
        per[f"{grid}_bound_by"] = ("bytes" if bytes_s.sum() >= ops_s.sum()
                                   else "operations")
    print(f"[q timing] fused_expand_q over the {n_levels} levels of batch 0, "
          f"device time per launch (CUDA graph of 10): dense grid mean "
          f"{per['dense_ms']:.4f} ms (max {np.max(t['dense']):.4f}; bound "
          f"{per['dense_bound_ms']:.6f} by {per['dense_bound_by']}: bytes "
          f"{per['dense_bytes_ms']:.6f}, operations {per['dense_ops_ms']:.6f})"
          f"; compacted list mean {per['compact_ms']:.4f} ms (max "
          f"{np.max(t['compact']):.4f}; bound {per['compact_bound_ms']:.6f} by "
          f"{per['compact_bound_by']}: bytes {per['compact_bytes_ms']:.6f}; "
          f"{per['tiles']:.0f} of {tg.num_tiles} tiles on average); "
          f"compaction {per['compaction_ms']:.4f} ms; not bounds: the q "
          f"rows of live source rows would take "
          f"{1e3 * np.mean(t['bytes_rows']) / HBM_BYTES_PER_S:.4f} ms on "
          f"average (max {1e3 * np.max(t['bytes_rows']) / HBM_BYTES_PER_S:.4f})"
          f", the whole q8 stack {1e3 * q8.numel() / HBM_BYTES_PER_S:.4f} ms")
    per["level_ms"] = {"dense": t["dense"], "compact": t["compact"]}
    for k in ("dense", "compact", "compaction", "tiles"):
        print(f"[q timing] {k} per level: {[round(x, 4) for x in t[k]]}")
    return per


def check_q_statistics(g_rev, sizes_q: torch.Tensor) -> dict:
    """(b) The mean RRR set size of the main path's traversals against as
    many exact CSR IC traversals (batches Q_BATCHES.., other roots and
    seeds): within Q_STAT_SE standard errors of the difference, from the
    observed spread.  At p = 0.25, q = 63 and p̂ = 64/256 exactly."""
    from repro_torch.core import rrr, traversal

    n = g_rev.num_vertices
    sizes_e = torch.cat([_colour_sizes(traversal.run_fused(
        g_rev, rrr.batch_starts(n, 64, 0, b), 64,
        rrr.batch_seed(0, b)).visited, 64)
        for b in range(Q_BATCHES, 2 * Q_BATCHES)])
    mq, me = float(sizes_q.mean()), float(sizes_e.mean())
    se = float(np.sqrt(float(sizes_q.var()) / sizes_q.numel()
                       + float(sizes_e.var()) / sizes_e.numel()))
    _check(abs(mq - me) <= Q_STAT_SE * se,
           f"q statistics: mean RRR set {mq:.2f} (quantised) vs {me:.2f} "
           f"(exact CSR) differ by more than {Q_STAT_SE} × {se:.2f}")
    print(f"[q exact b] p = 0.25 quantises to q = 63, p̂ = 64/256 exactly: "
          f"mean RRR set size {mq:.3f} over {sizes_q.numel()} quantised "
          f"traversals, {me:.3f} over {sizes_e.numel()} exact CSR ones; "
          f"|difference| {abs(mq - me):.3f} ≤ {Q_STAT_SE} × standard error "
          f"{se:.3f} = {Q_STAT_SE * se:.3f}")
    return dict(mean_q=mq, mean_exact=me, se=se)


def check_q_p1(tg, g_rev) -> None:
    """(a) Every edge at p = 1 (q = 255) in the main graph's layout: the
    quantised traversal must be the CSR sweep's BFS word for word."""
    from repro_torch.core import rrr, tiled_traversal, tiles, traversal
    from repro_torch.graph import csr

    n = g_rev.num_vertices
    src, dst, _ = g_rev.edges_numpy()
    g1 = csr.from_edges(src, dst, np.ones(len(src), np.float32), n,
                        device=g_rev.device)
    tg1, q1 = tiles.quantized(g1)
    _check(torch.equal(tg1.tile_src, tg.tile_src)
           and torch.equal(tg1.dst_run_ptr, tg.dst_run_ptr),
           "the p = 1 layout differs from the main one")
    levels = []
    for b, frontier in ((0, "dense"), (1, "sparse")):
        starts, seed = rrr.batch_starts(n, 64, 0, b), rrr.batch_seed(0, b)
        vis, lv, _ = tiled_traversal.run_fused_q_tiled(
            tg1, q1, starts, 64, seed, frontier=frontier)
        want = traversal.run_fused(g1, starts, 64, seed)
        _check(lv == want.stats.levels_run and torch.equal(vis, want.visited),
               f"q at p = 1 ({frontier}, batch {b}) differs from the CSR BFS")
        levels.append(lv)
    print(f"[q exact a] every edge at p = 1 (q = 255): batches 0 (dense grid) "
          f"and 1 (compacted list) equal the CSR sweep's BFS word for word "
          f"({levels} levels, mean RRR set "
          f"{float(_colour_sizes(vis, 64).mean()):.1f} vertices)")


def run_q_phases(golden: dict, dev) -> dict:
    """Phases 10-13 (module docstring); returns the kernel's numbers."""
    from repro_torch.core import tiles

    check_q_golden(golden, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g_rev, tg, q8, reorder_s = _q_graph(Q_N, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    T2 = tg.tile_size ** 2
    q8_gib = q8.numel() / 2 ** 30
    print(f"[q graph] powerlaw_cluster({Q_N}, {Q_DEGREE}, p={Q_PROB}, seed "
          f"{Q_GRAPH_SEED}), deduped, cluster order ({reorder_s:.2f}s of host "
          f"time), reversed: {g_rev.num_edges} edges, {tg.num_tiles} tiles "
          f"({g_rev.num_edges / tg.num_tiles:.2f} edges per tile; ids up to "
          f"{tg.num_tiles - 1}, past the wrap at {2 ** 32 // T2}); q8 stack "
          f"{q8_gib:.2f} GiB; the float32 prob and int32 edge-id stacks "
          f"would take {tg.num_tiles * T2 * 8 / 2 ** 30:.2f} GiB (by "
          f"reckoning, not allocated); graph and layout built in "
          f"{build_s:.2f}s; peak device memory {_peak_gib():.2f} GiB")
    slots = tiles.q_slot_list(tg, q8)
    _, counts = torch.unique(slots.key, return_counts=True)
    shared = counts[counts > 1].long()
    collide = dict(slots_sharing=int(shared.sum()),
                   pairs=int((shared * (shared - 1) // 2).sum()))
    print(f"[q graph] slot list: {slots.num_entries} slots with q > 0 "
          f"({slots.num_entries / tg.num_tiles:.2f} per tile, "
          f"{slots.nbytes / 2 ** 20:.2f} MiB); the uint32 cell counter gives "
          f"{counts.numel()} distinct cells: {collide['slots_sharing']} "
          f"slots share their cell with another, {collide['pairs']} pairs")
    del slots, counts, shared
    chk = check_q_kernel_full(tg, q8, dev)
    main = run_q_main_path(tg, q8, g_rev)
    torch.cuda.reset_peak_memory_stats()
    tim = time_q_kernel(tg, q8, g_rev)
    for grid, frontier, name in (("dense", "dense", "dense grid"),
                                 ("compact", "sparse", "compacted list")):
        ms, kern = main["batch0_ms"][frontier], float(np.sum(
            tim["level_ms"][grid]))
        print(f"[q timing] batch 0 end to end on the {name} {ms:.2f} ms "
              f"(main path); its levels' kernel times sum to {kern:.2f} ms "
              f"({kern / ms:.1%})")
    print(f"[q timing] peak device memory {_peak_gib():.2f} GiB")
    stats = check_q_statistics(g_rev, main["sizes"])
    # The p = 1 stack takes another 9 GiB: release the p = 0.25 one first.
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    check_q_p1(tg, g_rev)
    del tim["level_ms"]
    return dict(tim, launches=main["launches"]["fused_expand_q"],
                levels=main["levels"], batch_dense_ms=main["batch_dense_ms"],
                batch_compact_ms=main["batch_compact_ms"],
                plain_ms=chk["plain_ms"],
                max_abs_err=max(chk["max_abs_err"], tim["max_abs_err"]),
                reorder_s=reorder_s, num_tiles=tg.num_tiles, q8_gib=q8_gib,
                cell_collisions=collide, **stats)


# --------------------------------------------------------------- LM phases
def _flash_cases():
    """(name, B, Lq, Lk, H, KVH, D, causal, kv_offset) of the kernel
    checks: the main path's two shapes first, then maverick's (a group of
    5 query heads a KV head)."""
    cases = [("main prefill", 4, 2048, 2048, 24, 8, 128, True, 0),
             ("main decode", 4, 1, 2080, 24, 8, 128, True, 2079),
             ("maverick prefill", 4, 2048, 2048, 40, 8, 128, True, 0),
             ("maverick decode", 4, 1, 2080, 40, 8, 128, True, 2079)]
    for causal in (True, False):
        cases += [
            ("H/KVH 1, D 64", 2, 128, 128, 4, 4, 64, causal, 0),
            ("H/KVH 3, D 96, ragged", 2, 100, 100, 6, 2, 96, causal, 0),
            ("H/KVH 8, D 128, ragged Lk", 1, 130, 190, 8, 1, 128, causal, 60),
            ("H/KVH 3, D 192", 1, 65, 129, 6, 2, 192, causal, 64),
            ("H/KVH 1, D 16", 3, 33, 33, 4, 4, 16, causal, 0),
            ("decode, H/KVH 8, D 64", 2, 1, 77, 8, 1, 64, causal, 40),
            ("decode, H/KVH 3, D 128", 2, 1, 2080, 24, 8, 128, causal, 1500),
            ("H/KVH 3, D 64, ragged, 4 key blocks", 2, 200, 457, 6, 2, 64,
             causal, 257),
            ("decode, H/KVH 12, D 96", 1, 1, 300, 12, 1, 96, causal, 150),
        ]
    return cases


def _flash_close(got, want, dtype, what: str) -> tuple[float, float]:
    """Hold a kernel's output against its plain version (in float32):
    float32 within F32_TOL max abs, bf16 within atol = rtol = BF16_TOL and
    a relative RMS difference within BF16_RMS_TOL; returns the largest
    absolute difference and the relative RMS difference."""
    diff = got.float() - want.float()
    worst = float(diff.abs().max())
    rrms = float(diff.square().mean().sqrt()
                 / want.float().square().mean().sqrt().clamp_min(1e-30))
    if dtype == torch.float32:
        _check(worst <= F32_TOL, f"{what}: max abs err {worst} > {F32_TOL}")
    else:
        bad = diff.abs() > BF16_TOL + BF16_TOL * want.float().abs()
        _check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements "
               f"outside atol = rtol = {BF16_TOL}")
        _check(rrms <= BF16_RMS_TOL, f"{what}: relative RMS difference "
               f"{rrms} > {BF16_RMS_TOL}")
    return worst, rrms


def check_flash(dev) -> dict:
    """flash_attention against its plain version on the card, through
    ``ops.flash_attention`` (which picks the route by shape); each decode
    case also against the split-K plain version cut at the kernel's own
    split.  Fails unless every route ran at least one case; returns the
    largest absolute difference per dtype (compared in float32), the
    largest bf16 relative RMS difference per route and the cases per
    route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    per_route = dict.fromkeys(fa.ROUTES, 0)
    rms = dict.fromkeys(fa.ROUTES, 0.0)
    n = 0
    for name, b, lq, lk, h, kvh, d, causal, off in _flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, lq, h, d), generator=gen, device=dev)
            k = torch.randn((b, lk, kvh, d), generator=gen, device=dev)
            v = torch.randn((b, lk, kvh, d), generator=gen, device=dev)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            r = fa.route(dtype, b, lq, lk, h, kvh, d, causal)
            before = ops.LAUNCHES[f"flash_{r}"]
            got = ops.flash_attention(q, k, v, causal=causal, kv_offset=off)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           kv_offset=off)
            torch.cuda.synchronize()
            _check(ops.LAUNCHES[f"flash_{r}"] == before + 1,
                   f"flash_attention {name}: route {r} not launched")
            worst, rrms = _flash_close(got, want, dtype,
                                       f"flash_attention {r} {dtype} {name}")
            if r == "decode":
                chunk, _ = fa.decode_split(
                    b, kvh, h, fa.visible_keys(lk, causal, off), sms)
                split = ref.flash_decode_splitk_ref(
                    q, k, v, chunk=chunk, causal=causal, kv_offset=off)
                w2, r2 = _flash_close(got, split, dtype, f"flash_attention "
                                      f"decode {dtype} {name} against the "
                                      f"split-K plain version")
                worst, rrms = max(worst, w2), max(rrms, r2)
            err[dtype] = max(err[dtype], worst)
            if dtype == torch.bfloat16:
                rms[r] = max(rms[r], rrms)
            per_route[r] += 1
            n += 1
    missing = [r for r, c in per_route.items() if c == 0]
    _check(not missing, f"flash_attention: no case ran route(s) {missing}")
    print(f"[flash] {n} cases (f32 and bf16, causal and not, kv_offset 0 "
          f"and > 0, H/KVH 1/3/5/8/12, D 16-192, ragged Lq and Lk, the main "
          f"path's and maverick's prefill and decode shapes; decode also "
          f"against the "
          f"split-K plain version at its split) per route {per_route}: max "
          f"abs err f32 {err[torch.float32]:.3e} (limit {F32_TOL}), bf16 "
          f"{err[torch.bfloat16]:.3e} (atol = rtol = {BF16_TOL}); bf16 "
          f"relative RMS diff per route "
          + ", ".join(f"{r} {x:.3e}" for r, x in rms.items())
          + f" (limit {BF16_RMS_TOL})")
    return {"f32": err[torch.float32], "bf16": err[torch.bfloat16],
            "bf16_rrms": rms, "cases": per_route}


def _logit_errors(logits: torch.Tensor, gold: dict) -> tuple[float, int]:
    """Largest difference from the golden summary of (B, V) float32
    logits, and the number of rows whose greedy token was checked."""
    lg = logits.double()
    ids = torch.as_tensor(gold["ids"], device=lg.device)
    got = {"logits_at_ids": lg[:, ids], "max": lg.max(-1).values,
           "lse": torch.logsumexp(lg, -1)}
    worst = 0.0
    for key, val in got.items():
        want = torch.as_tensor(gold[key], dtype=torch.float64,
                               device=lg.device)
        worst = max(worst, float((val - want).abs().max()))
    checked = 0
    argmax = lg.argmax(-1).tolist()
    for row, (a, want, gap) in enumerate(zip(argmax, gold["argmax"],
                                             gold["top2_gap"])):
        if gap > LM_TOL:
            _check(a == want, f"LM golden: greedy token {a} != {want} in row "
                   f"{row} (top-2 gap {gap})")
            checked += 1
    return worst, checked


def _check_golden_model(gold: dict, cfg, dev, tag: str, tree) -> dict:
    """``cfg``'s model on the golden entry's weights (``tree``, drawn by
    `numpy_params`), prompt and teacher-forced tokens, float32 with TF32
    off, against the
    entry within LM_TOL, and every MoE call's expert picks equal to the
    entry's ``routes``; GQA layers launch flash_attention on the simt
    route for the prefill and the decode route for each step, MLA layers
    none."""
    from repro_torch import convert
    from repro_torch.kernels import ops
    from repro_torch.models import mlp

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in full
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params = convert.lm_params_from_jax(tree, cfg, dev)
    del tree
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    prompt = torch.as_tensor(gold["prompt"], device=dev)
    steps = len(gold["decode"])
    picked, route = [], mlp._route

    def recording(router, xt, k):     # the port's picks, call by call
        gate, idx, aux = route(router, xt, k)
        picked.append(idx.cpu())
        return gate, idx, aux

    mlp._route = recording
    try:
        worst, checked = _run_golden_model(gold, cfg, params, prompt, steps)
    finally:
        mlp._route = route
    torch.cuda.synchronize()
    picks = _check_routes(picked, gold.get("routes", []), tag)
    weights_gib = sum(t.numel() * t.element_size()
                      for t in params.parameters()) / 2 ** 30
    del params
    launches = ops.LAUNCHES["flash_attention"]
    routes = {r: ops.LAUNCHES[f"flash_{r}"] for r in ("simt", "decode")}
    gqa = 0 if cfg.attention == "mla" else cfg.num_layers
    _check(worst <= LM_TOL, f"{tag}: largest difference {worst} > {LM_TOL}")
    _check(launches == gqa * (1 + steps),
           f"{tag}: flash_attention launched {launches} times, not "
           f"{gqa * (1 + steps)}")
    # float32: the prefill on the simt route, every decode step on the
    # decode route.
    _check(routes == {"simt": gqa, "decode": gqa * steps},
           f"{tag}: routes launched {routes}, not simt {gqa} and decode "
           f"{gqa * steps}")
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers at full width "
          f"(d {cfg.d_model}, vocab {cfg.vocab_size}), float32, weights "
          f"{weights_gib:.2f} GiB loaded in {load_s:.1f}s: prefill "
          f"{tuple(prompt.shape)} and {steps} teacher-forced steps within "
          f"{worst:.3e} of the reference (limit {LM_TOL}); {checked} greedy "
          f"tokens equal; "
          + (f"{picks} expert picks equal; " if picks else "")
          + f"flash launches {launches} ({routes}); peak device memory "
          f"{_peak_gib():.2f} GiB")
    return {"max_abs_err": worst, "launches": launches, "load_s": load_s,
            "expert_picks": picks}


def _run_golden_model(gold: dict, cfg, params, prompt, steps: int):
    """The golden entry's prefill and teacher-forced steps; returns the
    largest logit difference and the greedy tokens checked."""
    from repro_torch.models import decode
    from repro_torch.serve import engine

    with torch.inference_mode():
        last, caches, _ = engine.prefill(params, cfg, {"tokens": prompt},
                                         prompt.shape[1] + steps)
        worst, checked = _logit_errors(last[:, -1].float(),
                                       {"ids": gold["vocab_ids"],
                                        **gold["prefill"]})
        for st in gold["decode"]:
            tok = torch.as_tensor(st["tokens"], device=prompt.device)[:, None]
            lg, caches = decode.decode_step(params, cfg, caches, tok,
                                            st["cur_len"])
            w, c = _logit_errors(lg[:, -1].float(),
                                 {"ids": gold["vocab_ids"], **st})
            worst, checked = max(worst, w), checked + c
    return worst, checked


def _check_routes(got: list, want: list, tag: str) -> int:
    """The port's expert picks (one (tokens, k) tensor per MoE call) equal
    the golden's, call for call; returns the picks compared."""
    _check(len(got) == len(want), f"{tag}: {len(got)} MoE calls, the "
           f"reference made {len(want)}")
    for call, (g, w) in enumerate(zip(got, want)):
        w = torch.as_tensor(w)
        bad = (g != w).nonzero()
        _check(g.shape == w.shape and not len(bad),
               f"{tag}: MoE call {call} picks other experts than the "
               f"reference, first at (token, slot) "
               f"{bad[0].tolist() if len(bad) else None}")
    return sum(len(w) * len(w[0]) for w in want)


def check_lm_golden(golden: dict, dev) -> dict:
    """llama3.2-3b at full width, 2 layers, float32, on the golden file's
    weights (`numpy_params`), prompt and teacher-forced tokens."""
    from repro_torch.configs import registry

    from repro_torch.models import init

    gold = golden["lm"]
    cfg = dataclasses.replace(registry.get(gold["arch"]),
                              num_layers=gold["num_layers"],
                              dtype=gold["dtype"])
    t0 = time.perf_counter()
    tree = init.numpy_params(cfg, gold["param_seed"])
    print(f"[lm golden] weights drawn in {time.perf_counter() - t0:.1f}s")
    return _check_golden_model(gold, cfg, dev, "lm golden", tree)


def check_moe_golden(golden: dict, dev) -> dict:
    """The ``"moe"`` entries (deepseek-v3 and maverick at full width, cut
    in depth and experts, float32): the model as `check_lm_golden` checks
    llama, and every expert pick equal to the reference's.  numpy draws
    the entries' weights (~13 GB each) in threads of their own, at once
    (its draws release the interpreter lock), while the card checks the
    first."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import registry
    from repro_torch.models import init

    cfgs = {}
    for name, gold in golden["moe"].items():
        cuts = {k: v for k, v in gold["cuts"].items() if k != "arch"}
        cfgs[name] = dataclasses.replace(registry.get(gold["arch"]), **cuts)
    t0 = time.perf_counter()
    out = {}
    with ThreadPoolExecutor(len(cfgs)) as pool:
        trees = {name: pool.submit(init.numpy_params, cfg,
                                   golden["moe"][name]["param_seed"])
                 for name, cfg in cfgs.items()}
        for name, cfg in cfgs.items():
            gold = golden["moe"][name]
            tree = trees.pop(name).result()
            print(f"[moe golden {name}] cuts {gold['cuts']}; weights drawn "
                  f"{time.perf_counter() - t0:.1f}s after the draws began; "
                  f"the reference's router margin (nearest tie between the "
                  f"k-th and (k+1)-th expert) {gold['router_margin']:.3e} "
                  f"over {gold['moe_calls']} MoE calls")
            out[name] = _check_golden_model(gold, cfg, dev,
                                            f"moe golden {name}", tree)
            del tree
            out[name]["router_margin"] = gold["router_margin"]
            _release(f"moe golden {name}")
    return out


def check_lm_bf16(dev) -> dict:
    """llama3.2-3b at full width, LM_BF16_LAYERS layers, bf16, the port's
    seeded init: the prefill logits of LM_BF16_BATCH prompts of
    LM_BF16_PROMPT tokens through the kernels (the wgmma route) against
    the same forward with ``ops.flash_attention`` patched, for that one
    forward, to the plain version; limits LM_BF16_MAX_TOL (max abs) and
    LM_BF16_MEAN_TOL (mean abs), greedy tokens equal where the plain run's
    top-2 gap exceeds 2 x LM_BF16_MAX_TOL."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model

    cfg = dataclasses.replace(registry.get(LM_ARCH),
                              num_layers=LM_BF16_LAYERS, dtype="bfloat16",
                              num_patches=0)
    params = model.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BF16_BATCH, LM_BF16_PROMPT))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.inference_mode():
        got = model.forward(params, cfg, {"tokens": prompt})[0]
        torch.cuda.synchronize()
        wgmma = ops.LAUNCHES["flash_wgmma"]
        kernel = ops.flash_attention
        ops.flash_attention = ref.flash_attention_ref
        try:
            want = model.forward(params, cfg, {"tokens": prompt})[0]
        finally:
            ops.flash_attention = kernel
        worst, total, checked = 0.0, 0.0, 0
        for row in range(LM_BF16_BATCH):
            g, w = got[row].float(), want[row].float()
            diff = (g - w).abs()
            worst = max(worst, float(diff.max()))
            total += float(diff.sum())
            top2 = w.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_BF16_MAX_TOL
            _check(bool((g.argmax(-1) == w.argmax(-1))[sure].all()),
                   f"LM bf16: a greedy token differs in row {row} where "
                   f"the top-2 gap exceeds {2 * LM_BF16_MAX_TOL}")
            checked += int(sure.sum())
        mean = total / got.numel()
        spread = float(want.float().std())
    torch.cuda.synchronize()
    _check(wgmma == cfg.num_layers, f"LM bf16: wgmma route launched "
           f"{wgmma} times, not {cfg.num_layers}")
    _check(worst <= LM_BF16_MAX_TOL and mean <= LM_BF16_MEAN_TOL,
           f"LM bf16: logits differ by max {worst}, mean {mean} (limits "
           f"{LM_BF16_MAX_TOL}, {LM_BF16_MEAN_TOL})")
    print(f"[lm bf16] {cfg.name}, {cfg.num_layers} layers at full width, "
          f"bf16, batch {LM_BF16_BATCH} x prompt {LM_BF16_PROMPT}: prefill "
          f"logits through the wgmma route ({wgmma} launches) against "
          f"plain attention: max abs diff {worst:.4e} (limit "
          f"{LM_BF16_MAX_TOL}), mean {mean:.4e} (limit {LM_BF16_MEAN_TOL}),"
          f" logit spread {spread:.3f}; {checked} greedy tokens checked "
          f"equal; peak device memory {_peak_gib():.2f} GiB")
    return {"max_abs_err": worst, "mean_abs_err": mean}


def run_lm_main_path() -> dict:
    """llama3.2-3b at full width through the launcher, request mixes (a)
    and (b); returns each run's numbers and the flash launches of both."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    out = {}
    ops.reset_launches()
    for mix, (prompt_len, temp) in LM_MIXES.items():
        before = dict(ops.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        r = serve.run(serve.parse_args([
            "--arch", LM_ARCH, "--device", "cuda", "--batch", str(LM_BATCH),
            "--prompt-len", str(prompt_len), "--new-tokens", str(LM_NEW),
            "--temperature", str(temp)]))
        torch.cuda.synchronize()
        cfg, tokens = r["cfg"], r["tokens"]
        launches = ops.LAUNCHES["flash_attention"] \
            - before["flash_attention"]
        routes = {r: ops.LAUNCHES[f"flash_{r}"] - before[f"flash_{r}"]
                  for r in ("wgmma", "decode", "simt")}
        want = cfg.num_layers * (1 + LM_NEW)
        # bf16: each layer's prefill on the wgmma route, each decode step
        # on the decode route.
        want_routes = {"wgmma": cfg.num_layers,
                       "decode": cfg.num_layers * LM_NEW, "simt": 0}
        _check(r["finite"], f"LM ({mix}): non-finite logits")
        _check(tokens.shape == (LM_BATCH, LM_NEW)
               and int(tokens.min()) >= 0
               and int(tokens.max()) < cfg.vocab_size,
               f"LM ({mix}): tokens malformed")
        _check(launches == want, f"LM ({mix}): flash_attention launched "
               f"{launches} times, not {want}")
        _check(routes == want_routes, f"LM ({mix}): routes launched "
               f"{routes}, not {want_routes}")
        out[mix] = dict(prompt_len=prompt_len, temperature=temp,
                        prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                        decode_ms=r["decode_ms_per_step"],
                        prefill_tok_s=LM_BATCH * prompt_len / r["prefill_s"],
                        decode_tok_s=LM_BATCH * LM_NEW / r["decode_s"],
                        launches=launches, routes=routes,
                        peak_gib=_peak_gib())
        m = out[mix]
        print(f"[lm main {mix}] {cfg.name} ({cfg.num_layers} layers, "
              f"{cfg.dtype}, {cfg.param_count() / 1e9:.3f} B parameters): "
              f"batch {LM_BATCH}, prompt {prompt_len}, {LM_NEW} new tokens "
              f"at temperature {temp}: prefill {m['prefill_s']:.4f}s "
              f"({m['prefill_tok_s']:.0f} tokens/s), decode "
              f"{m['decode_ms']:.3f} ms/step ({m['decode_tok_s']:.1f} "
              f"tokens/s); flash launches {launches} {routes}; peak "
              f"device memory {m['peak_gib']:.2f} GiB; tokens[0][:8] "
              f"{tokens[0, :8].tolist()}")
    out["launches"] = dict(ops.LAUNCHES)
    print(f"[lm main] launches over (a) and (b): {out['launches']}")
    return out


def run_moe_main_path() -> dict:
    """deepseek-v3 and llama4-maverick at full width with their depth cut
    (MOE_MAIN), bf16, the port's seeded init, through the launcher's
    `serve_config`, each with request mixes (a) and (b), one model on the
    card at a time.  Counters as in 4 for each request batch: maverick's
    two GQA layers launch 2 wgmma + 2 × 32 decode, deepseek's MLA none."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import mlp, model

    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    out = {}
    for arch, layers in MOE_MAIN.items():
        cfg = dataclasses.replace(registry.get(arch), num_layers=layers,
                                  num_patches=0)
        kinds = model.layer_kinds(cfg)
        gqa = 0 if cfg.attention == "mla" else cfg.num_layers
        fe = cfg.moe_d_ff or cfg.d_ff
        # Every expert's weights, bf16, in every MoE layer: a decode step's
        # bmm reads them all whenever the capacity is at least 1.
        expert_bytes = kinds.count("moe") * cfg.num_experts \
            * (3 if cfg.gated_mlp else 2) * cfg.d_model * fe * 2
        want = {"flash_attention": gqa * (1 + LM_NEW), "flash_wgmma": gqa,
                "flash_decode": gqa * LM_NEW, "flash_simt": 0}
        res = {}
        for mix, (prompt_len, temp) in LM_MIXES.items():
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            r = serve.serve_config(cfg, serve.parse_args([
                "--arch", arch, "--device", "cuda", "--batch",
                str(LM_BATCH), "--prompt-len", str(prompt_len),
                "--new-tokens", str(LM_NEW), "--temperature", str(temp)]))
            torch.cuda.synchronize()
            launches = {k: ops.LAUNCHES[k] for k in want}
            tokens, peak = r["tokens"], _peak_gib()
            _check(r["finite"], f"{arch} ({mix}): non-finite logits")
            _check(tokens.shape == (LM_BATCH, LM_NEW)
                   and int(tokens.min()) >= 0
                   and int(tokens.max()) < cfg.vocab_size,
                   f"{arch} ({mix}): tokens malformed")
            _check(launches == want, f"{arch} ({mix}): launches {launches}, "
                   f"not {want}")
            _check(peak < card, f"{arch} ({mix}): peak {peak} GiB")
            m = dict(prompt_len=prompt_len, temperature=temp,
                     prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                     decode_ms=r["decode_ms_per_step"],
                     prefill_tok_s=LM_BATCH * prompt_len / r["prefill_s"],
                     expert_bound_ms=1e3 * expert_bytes / HBM_BYTES_PER_S,
                     weights_bound_ms=1e3 * r["param_bytes"]
                     / HBM_BYTES_PER_S,
                     weights_gib=r["param_bytes"] / 2 ** 30,
                     prefill_capacity=mlp.capacity(LM_BATCH * prompt_len,
                                                   cfg),
                     decode_capacity=mlp.capacity(LM_BATCH, cfg),
                     launches=launches, peak_gib=peak)
            res[mix] = m
            print(f"[moe main {mix}] {cfg.name}: {cfg.num_layers} layers "
                  f"({'/'.join(kinds)}) at full width, {cfg.dtype}, "
                  f"{r['param_bytes'] / 2 ** 30:.2f} GiB of weights "
                  f"(param_count {cfg.param_count() / 1e9:.3f} B); batch "
                  f"{LM_BATCH}, prompt {prompt_len}, {LM_NEW} new tokens at "
                  f"temperature {temp}: prefill {m['prefill_s']:.4f}s "
                  f"({m['prefill_tok_s']:.0f} tokens/s), decode "
                  f"{m['decode_ms']:.3f} ms/step against "
                  f"{m['expert_bound_ms']:.3f} ms to read every expert "
                  f"once ({expert_bytes / 1e9:.2f} GB at 3.35 TB/s; all "
                  f"weights {m['weights_bound_ms']:.3f} ms); capacity per "
                  f"MoE layer {m['prefill_capacity']} rows an expert at "
                  f"prefill, {m['decode_capacity']} at decode "
                  f"({cfg.num_experts} experts, top-{cfg.top_k}); flash "
                  f"launches {launches}; peak device memory {peak:.2f} GiB "
                  f"of {card:.2f}; tokens[0][:8] {tokens[0, :8].tolist()}")
            del r, tokens
            _release(f"{arch} ({mix})")
        if cfg.attention == "mla":
            latent = (cfg.kv_lora_rank + cfg.rope_head_dim) * 2
            full = cfg.num_heads * (cfg.head_dim + cfg.rope_head_dim
                                    + (cfg.v_head_dim or cfg.head_dim)) * 2
            res["cache_bytes_per_token_layer"] = latent
            res["gqa_bytes_per_token_layer"] = full
            print(f"[moe main] {cfg.name}: the MLA latent cache holds "
                  f"{latent} bytes a token a layer (c {cfg.kv_lora_rank} + "
                  f"k_rope {cfg.rope_head_dim}, bf16), against {full} for "
                  f"K ({cfg.head_dim + cfg.rope_head_dim}) and V "
                  f"({cfg.v_head_dim or cfg.head_dim}) of {cfg.num_heads} "
                  f"heads: {full / latent:.1f}x smaller")
        out[arch] = res
    return out


def run_moe_a2a_phase(golden: dict) -> dict:
    """The expert-parallel MoE on a 2x2 gloo world of 4 ranks sharing card
    0 (`mesh_smoke.rank_moe_a2a`): every rank's gathered output against the
    golden ``"moe_a2a"`` entry within MOE_A2A_TOL (values at 256 indices,
    aux, the magnitude sum relative), and at capacity factor 64 against
    the one-device scatter."""
    from repro_torch.launch import accel, mesh_smoke

    gold = golden["moe_a2a"]
    t0 = time.perf_counter()
    ranks = accel.spawn(mesh_smoke.rank_moe_a2a, 4, args=(gold,),
                        backend="gloo", device="cuda", timeout_s=300)
    seconds = time.perf_counter() - t0
    want = np.asarray(gold["values"])
    worst = 0.0
    for r in ranks:
        _check(r["routes_equal"], f"moe a2a: rank {r['rank']} picks other "
               f"experts than the reference")
        err = max(float(np.abs(r["values"] - want).max()),
                  abs(r["aux"] - gold["aux"]),
                  abs(r["abs_sum"] - gold["abs_sum"]) / gold["abs_sum"])
        _check(err <= MOE_A2A_TOL, f"moe a2a: rank {r['rank']} differs from "
               f"the reference by {err} (limit {MOE_A2A_TOL})")
        worst = max(worst, err)
    cf64 = ranks[0]["cf64_max_abs_diff"]
    _check(cf64 <= MOE_A2A_TOL, f"moe a2a: at capacity factor 64 the a2a "
           f"differs from the one-device scatter by {cf64}")
    r0 = ranks[0]
    print(f"[moe a2a] {gold['arch']} widths, {gold.get('overrides', {})}, "
          f"float32, "
          f"2 x {gold['seq']} tokens on a 2x2 {r0['backend']} world sharing "
          f"the card ({seconds:.1f}s with the ranks' start): every rank "
          f"within {worst:.3e} of the reference's a2a (limit "
          f"{MOE_A2A_TOL}; aux {r0['aux']:.6f}, golden {gold['aux']:.6f}), "
          f"every expert pick the reference's (router margin "
          f"{gold['router_margin']:.3e}); "
          f"capacity {r0['capacity']} rows an expert for {r0['tokens']} "
          f"tokens a rank; at capacity factor 64 within {cf64:.3e} of the "
          f"one-device scatter; per rank: one all-to-all of "
          f"{r0['a2a_bytes']} bytes takes "
          + ", ".join(f"{r['a2a_ms']:.3f}" for r in ranks)
          + f" ms (host clock, staged through the host), the layer made "
          f"{r0['model_stats']['model']['calls']} calls over model "
          f"({r0['model_stats']['model']['bytes']} bytes), "
          f"{r0['staged_bytes']} bytes staged; peak "
          + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB")
    return {"max_abs_err": worst, "cf64_max_abs_diff": cf64,
            "a2a_ms": [r["a2a_ms"] for r in ranks],
            "a2a_bytes": r0["a2a_bytes"], "seconds": seconds}


def time_flash(dev) -> dict:
    """At (b)'s prefill and decode shapes (bf16): the route the main path
    takes there and the simt route (the CUDA-core design) from CUDA graphs
    of 10 launches, the plain version (CUDA events), and SDPA both from a
    CUDA graph of 10 launches like the kernels and with events around one
    eager call; each beside the function's bound on this card."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, kvh, d = LM_BATCH, 24, 8, 128
    lp = LM_MIXES["b"][0]
    per = {}
    for shape, lq, lk, off, causal in (
            ("prefill", lp, lp, 0, True),
            ("decode", 1, lp + LM_NEW, lp + LM_NEW - 1, True)):
        q = torch.randn((b, lq, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, lk, kvh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, lk, kvh, d), generator=gen, device=dev).bfloat16()
        scale = d ** -0.5
        main_route = fa.route(torch.bfloat16, b, lq, lk, h, kvh, d, causal)

        def kernel(r):
            return lambda: fa.CUDA_ROUTES[r](q, k, v, causal=causal,
                                             scale=scale, kv_offset=off)

        def plain():
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           kv_offset=off)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # Every key is visible at decode (kv_offset = Lk - 1): no mask.
        sdpa_causal = causal and lq == lk

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=sdpa_causal, enable_gqa=True)

        want = plain()
        errs = {r: float((kernel(r)().float() - want.float()).abs().max())
                for r in (main_route, "simt")}
        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        del want
        ms = {main_route: _kernel_ms(kernel(main_route)),
              "simt": _kernel_ms(kernel("simt"))}
        plain_ms = _time_ms(plain, 3)
        lib_graph_ms = _kernel_ms(library)
        lib_eager_ms = _time_ms(library, 20)
        # Visible (query, key) pairs; 4·D operations each (two products).
        pairs = sum(min(lk, i + off + 1) for i in range(lq)) if causal \
            else lq * lk
        ops_ms = 1e3 * 4 * b * h * pairs * d / BF16_FLOPS_PER_S
        bytes_ms = 1e3 * 2 * (2 * b * lq * h * d + 2 * b * lk * kvh * d) \
            / HBM_BYTES_PER_S
        per[shape] = dict(
            route=main_route, ms=ms[main_route], simt_ms=ms["simt"],
            plain_ms=plain_ms, library_ms=lib_graph_ms,
            library_eager_ms=lib_eager_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            max_abs_err=errs[main_route], simt_max_abs_err=errs["simt"])
        t = per[shape]
        print(f"[timing flash] {shape} (B {b}, Lq {lq}, Lk {lk}, H {h}, KVH "
              f"{kvh}, D {d}, bf16, kv_offset {off}): {main_route} route "
              f"{t['ms']:.4f} ms, simt route {t['simt_ms']:.4f} ms "
              f"(CUDA graphs of 10), plain {plain_ms:.4f} ms, SDPA "
              f"{lib_graph_ms:.4f} ms from a CUDA graph of 10 and "
              f"{lib_eager_ms:.4f} ms with events around one eager call "
              f"(its max abs diff from plain {lib_err:.3e}); bound "
              f"{t['bound_ms']:.6f} ms by {t['bound_by']} ({ops_ms:.6f} "
              f"operations, {bytes_ms:.6f} bytes); max abs err from plain "
              f"{main_route} {errs[main_route]:.3e}, simt "
              f"{errs['simt']:.3e}")
    return per


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    t_all = time.time()
    gpu = _gpu_line()
    dev = torch.device("cuda")
    print(f"[env] {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f} "
          f"GiB of device memory")
    with open(GOLDEN) as f:
        golden = json.load(f)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} in {build_s:.2f}s")
    for name in _build.SOURCES:
        log = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        print(f"[build] {name}: {len(regs)} kernel(s), registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
              f"(stores + loads) {sum(spills)}" if regs
              else f"[build] {name}: no ptxas report")
    # cover_counts_kernel<W, Q, 16-byte loads>: registers per instantiation.
    cover = re.findall(r"cover_counts_kernelILi(\d)ELi(\d)ELb(\d)E.*?Used "
                       r"(\d+) registers", _build.build_log("coverage"),
                       re.S)
    print("[build] coverage registers (W, Q, 16-byte loads): "
          + ", ".join(f"({w}, {q}, {v == '1'}) {r}" for w, q, v, r in cover))

    torch.cuda.reset_peak_memory_stats()
    err = check_kernels(dev)
    print(f"[kernels] peak device memory {_peak_gib():.2f} GiB")

    out, launches = run_main_path(golden, "ic")
    check_outputs(out, golden)
    torch.cuda.reset_peak_memory_stats()
    fe = time_tile_kernel(out["store"], "ic")
    cc = time_cover_counts(out["store"])
    print(f"[timing ic] peak device memory {_peak_gib():.2f} GiB")
    ic = dict(build_s=out["build_s"], flush_s=out["flush_s"],
              reflush_s=out["reflush_s"],
              **{k: out[k] for k in ("snapshot_mib", "save_s", "restore_s")})
    # The LT stacks (prob, cb) take another 24.2 GiB at this size: release
    # the IC graph, its 24.2 GiB of tiles and the pools first, so that each
    # phase's peak device memory is its own.
    del out
    _release("IC phase")

    tier = run_tier_phase(golden)
    _release("tier phase")
    stream_ic = run_stream_phase(golden, "ic")
    _release("IC stream phase")

    out_lt, launches_lt = run_main_path(golden, "lt")
    check_outputs_lt(out_lt, golden)
    torch.cuda.reset_peak_memory_stats()
    lse = time_tile_kernel(out_lt["store"], "lt")
    print(f"[timing lt] peak device memory {_peak_gib():.2f} GiB")
    lt = dict(build_s=out_lt["build_s"], reflush_s=out_lt["reflush_s"],
              **{k: out_lt[k] for k in ("snapshot_mib", "save_s",
                                        "restore_s")})
    # The LM phases hold up to ~10 GiB: release the LT graph, its 24.2 GiB
    # of tiles and the pools first, as the IC phase's are above.
    del out_lt
    _release("LT phase")
    stream_lt = run_stream_phase(golden, "lt")
    _release("LT stream phase")
    unfused = run_unfused_phase(golden)
    _release("unfused phase")
    grid = run_table1_grid()
    _release("Table-1 grid")
    mesh = run_mesh_phase(golden, {"a": ic["build_s"], "b": lt["build_s"]})
    _release("mesh phase")

    q = run_q_phases(golden, dev)
    _release("quantised phases")

    torch.cuda.reset_peak_memory_stats()
    flash_err = check_flash(dev)
    print(f"[flash] peak device memory {_peak_gib():.2f} GiB")
    lm_gold = check_lm_golden(golden, dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_gold = check_moe_golden(golden, dev)
    lm_bf16 = check_lm_bf16(dev)
    gc.collect()
    torch.cuda.empty_cache()
    lm = run_lm_main_path()
    gc.collect()
    torch.cuda.empty_cache()
    moe = run_moe_main_path()
    a2a = run_moe_a2a_phase(golden)
    _release("MoE phases")
    torch.cuda.reset_peak_memory_stats()
    fl = time_flash(dev)
    print(f"[timing flash] peak device memory {_peak_gib():.2f} GiB")

    print(f"[result] build {build_s:.2f}s; IC pool build {ic['build_s']:.3f}s "
          f"for 64 batches ({64 / ic['build_s']:.2f} batches/s), mixed flush "
          f"{ic['flush_s'] * 1e3:.2f} ms (first in the process), "
          f"{ic['reflush_s'] * 1e3:.2f} ms (after the refresh); LT pool build "
          f"{lt['build_s']:.3f}s ({64 / lt['build_s']:.2f} "
          f"batches/s), mixed flush {lt['reflush_s'] * 1e3:.2f} ms after "
          f"the refresh; LM llama3.2-3b (b) prefill "
          f"{lm['b']['prefill_tok_s']:.0f} tokens/s, decode "
          f"{lm['b']['decode_ms']:.3f} ms/step; "
          + "; ".join(f"{arch} (b) prefill {r['b']['prefill_tok_s']:.0f} "
                      f"tokens/s, decode {r['b']['decode_ms']:.3f} ms/step "
                      f"(experts' bound {r['b']['expert_bound_ms']:.3f})"
                      for arch, r in moe.items())
          + f"; MoE a2a within {a2a['max_abs_err']:.3e} of the reference; "
          f"flash_attention prefill "
          f"{fl['prefill']['ms']:.4f} ms (wgmma; simt "
          f"{fl['prefill']['simt_ms']:.4f}), decode "
          f"{fl['decode']['ms']:.4f} ms (split-K; simt "
          f"{fl['decode']['simt_ms']:.4f}); fused_expand mean per level "
          f"{fe['dense_ms']:.4f} ms "
          f"(compacted {fe['compact_ms']:.4f}); lt_select_expand "
          f"{lse['compact_ms']:.4f} ms compacted ({lse['dense_ms']:.4f} "
          f"dense grid); batch 0 end to end IC {fe['batch_dense_ms']:.2f} / "
          f"{fe['batch_compact_ms']:.2f} ms, LT {lse['batch_dense_ms']:.2f} / "
          f"{lse['batch_compact_ms']:.2f} ms (dense / compacted grid); "
          f"cover_counts {cc['ms']:.4f} ms cold, {cc['warm_ms']:.4f} warm, "
          f"Q 8 {cc['multi']['ms']:.4f} cold; fused_expand_q at n {Q_N} "
          f"({q['num_tiles']} tiles, {q['q8_gib']:.2f} GiB) {q['dense_ms']:.4f} "
          f"ms dense / {q['compact_ms']:.4f} ms compacted per level, batch "
          f"{q['batch_dense_ms']:.2f} / {q['batch_compact_ms']:.2f} ms end to "
          f"end; total {time.time() - t_all:.1f}s")
    drv = stream_ic["driver"]
    print(f"[result lifecycle] snapshot of the 64-batch pool: IC "
          f"{ic['snapshot_mib']:.2f} MiB saved {ic['save_s']:.3f}s / "
          f"restored {ic['restore_s']:.3f}s, LT {lt['snapshot_mib']:.2f} MiB "
          f"{lt['save_s']:.3f}s / {lt['restore_s']:.3f}s; tier p50 "
          f"{tier['p50_ms']:.3f} ms, p99 {tier['p99_ms']:.3f} ms over "
          f"{tier['queries']} queries (peak {tier['peak_gib']:.2f} GiB); "
          + "; ".join(
              f"{name} stream: {r['dirty_slots']}/{r['total_slots']} dirty, "
              f"{r['touched_row_blocks']} row blocks, rebind "
              f"{r['rebind_s']:.3f}s + resample {r['resample_s']:.3f}s "
              f"(apply_plan {r['refresh_s']:.3f}s), cold {r['cold_s']:.3f}s, "
              f"peak {r['peak_gib']:.2f} GiB"
              for name, r in (("IC", stream_ic), ("LT", stream_lt)))
          + f"; driver 16 batches {drv['seconds']:.3f}s")
    print(f"[result mesh] 9d on one card: 64-batch pool IC 2x2 "
          f"{mesh['a']['build_dense_s']:.3f}s dense leg / "
          f"{mesh['a']['build_sparse_s']:.3f}s sparse leg (one device "
          f"{ic['build_s']:.3f}s), LT 2x2 {mesh['b']['build_dense_s']:.3f}s "
          f"/ {mesh['b']['build_sparse_s']:.3f}s (one device "
          f"{lt['build_s']:.3f}s); one level's exchange on 2x2: all-gather "
          f"{mesh['exchange']['dense_ms']:.3f} ms, butterfly "
          f"{mesh['exchange']['butterfly_ms']:.3f} ms, pmax "
          f"{mesh['exchange']['pmax_ms']:.3f} ms; words IC "
          f"{mesh['a']['words_dense']} dense / {mesh['a']['words_sparse']} "
          f"sparse; peak {mesh['a']['peak_gib']:.3f} GiB a rank (a); async "
          f"front end on 2x2, flush ms (mesh / one device) "
          + ", ".join(f"{op} {mesh['f']['mesh_ms'][op]:.3f} / "
                      f"{mesh['f']['one_ms'][op]:.3f}"
                      for op in ("sigma", "marginal", "top_k"))
          + f", whole-mesh broadcast {mesh['f']['broadcast_ms']:.3f} ms; "
          f"worlds "
          f"{mesh['seconds']['world_2x2']:.1f}s, "
          f"{mesh['seconds']['world_1x3']:.1f}s, "
          f"{mesh['seconds']['world_1x1']:.1f}s")
    kernels = [
        dict(name="fused_expand", route="cuda",
             source="src/repro_torch/csrc/fused_expand.cu",
             replaces="src/repro/kernels/fused_expand.py:99",
             launches=launches["fused_expand"],
             launches_by_path={
                 "ic_main": launches["fused_expand"],
                 "stream_ic": stream_ic["launches"]["fused_expand"],
                 "driver": drv["launches"]["fused_expand"],
                 "mesh_gp_ic_2x2": mesh["a"]["launches"]["fused_expand"],
                 "mesh_async_2x2": mesh["f"]["launches"]["fused_expand"],
                 "mesh_gp_ic_1x1_nccl": mesh["d"]["launches"][
                     "fused_expand"]},
             max_abs_err=max(err["fused_expand"], fe["max_abs_err"],
                             mesh["a"]["max_abs_err"]),
             ms=fe["dense_ms"], plain_ms=fe["plain_ms"],
             bound_ms=fe["dense_bound_ms"], bound_by=fe["dense_bound_by"],
             library_ms=None,
             compacted={"ms": fe["compact_ms"],
                        "bound_ms": fe["compact_bound_ms"],
                        "bound_by": fe["compact_bound_by"],
                        "compaction_ms": fe["compaction_ms"]},
             slot_list={k: fe[f"slot_{k}"] for k in (
                 "entries", "bytes", "build_ms")}),
        dict(name="cover_counts", route="cuda",
             source="src/repro_torch/csrc/coverage.cu",
             replaces="src/repro/kernels/coverage.py:41",
             launches=launches["cover_counts"],
             launches_by_path={
                 "ic_main": launches["cover_counts"],
                 "lt_main": launches_lt["cover_counts"],
                 "tier": tier["launches"]["cover_counts"],
                 "stream_ic": stream_ic["launches"]["cover_counts"],
                 "stream_lt": stream_lt["launches"]["cover_counts"],
                 "mesh_gp_ic_2x2": mesh["a"]["launches"]["cover_counts"],
                 "mesh_gp_lt_2x2": mesh["b"]["launches"]["cover_counts"],
                 "mesh_dp_4x1": mesh["c"]["launches"]["cover_counts"],
                 "mesh_async_2x2": mesh["f"]["launches"]["cover_counts"],
                 "mesh_gp_ic_1x1_nccl": mesh["d"]["launches"][
                     "cover_counts"]},
             max_abs_err=max(err["cover_counts"], cc["max_abs_err"],
                             *(mesh[t]["cover_max_abs_err"]
                               for t in "abcd")),
             ms=cc["ms"], plain_ms=cc["plain_ms"], bound_ms=cc["bound_ms"],
             bound_by=cc["bound_by"], library_ms=None,
             **{k: cc[k] for k in ("warm_ms", "eager_cold_ms",
                                   "clean_cold_ms")},
             multi=dict(cc["multi"], launches=launches["cover_counts_multi"],
                        launches_lt=launches_lt["cover_counts_multi"],
                        launches_mesh_async_2x2=mesh["f"]["launches"][
                            "cover_counts_multi"])),
        dict(name="lt_select_expand", route="cuda",
             source="src/repro_torch/csrc/lt_select_expand.cu",
             replaces="src/repro/kernels/lt_select_expand.py:101",
             launches=launches_lt["lt_select_expand"],
             launches_by_path={
                 "lt_main": launches_lt["lt_select_expand"],
                 "stream_lt": stream_lt["launches"]["lt_select_expand"],
                 "mesh_gp_lt_2x2": mesh["b"]["launches"][
                     "lt_select_expand"]},
             max_abs_err=max(err["lt_select_expand"], lse["max_abs_err"],
                             mesh["b"]["max_abs_err"]),
             ms=lse["compact_ms"], plain_ms=lse["plain_ms"],
             bound_ms=lse["compact_bound_ms"],
             bound_by=lse["compact_bound_by"],
             library_ms=None,
             dense={"ms": lse["dense_ms"], "bound_ms": lse["dense_bound_ms"],
                    "bound_by": lse["dense_bound_by"]},
             compaction_ms=lse["compaction_ms"],
             slot_list=True,
             slot_list_stats={k: lse[f"slot_{k}"] for k in (
                 "entries", "bytes", "build_ms")}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_prefill_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:83",
             launches=lm["launches"]["flash_attention"],
             max_abs_err=max(flash_err["f32"], flash_err["bf16"],
                             fl["prefill"]["max_abs_err"],
                             fl["decode"]["max_abs_err"]),
             max_abs_err_f32=flash_err["f32"],
             max_abs_err_bf16=flash_err["bf16"],
             lm_golden_max_abs_err=lm_gold["max_abs_err"],
             moe_golden_max_abs_err={k: v["max_abs_err"]
                                     for k, v in moe_gold.items()},
             lm_bf16_max_abs_err=lm_bf16["max_abs_err"],
             launches_by_path={
                 "lm_llama3.2-3b": lm["launches"]["flash_attention"],
                 **{f"moe_maverick_{mix}": moe[
                     "llama4-maverick-400b-a17b"][mix]["launches"][
                     "flash_attention"] for mix in LM_MIXES},
                 **{f"moe_deepseek_{mix}": moe["deepseek-v3-671b"][mix][
                     "launches"]["flash_attention"] for mix in LM_MIXES}},
             ms=fl["prefill"]["ms"], plain_ms=fl["prefill"]["plain_ms"],
             bound_ms=fl["prefill"]["bound_ms"],
             bound_by=fl["prefill"]["bound_by"],
             library_ms=fl["prefill"]["library_ms"],
             routes={
                 "wgmma": dict(
                     source="src/repro_torch/csrc/flash_prefill_wgmma.cu",
                     shape="prefill",
                     launches=lm["launches"]["flash_wgmma"],
                     cases=flash_err["cases"]["wgmma"],
                     bf16_rrms=flash_err["bf16_rrms"]["wgmma"],
                     **{k: fl["prefill"][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "library_eager_ms")}),
                 "decode": dict(
                     source="src/repro_torch/csrc/flash_decode.cu",
                     shape="decode",
                     launches=lm["launches"]["flash_decode"],
                     cases=flash_err["cases"]["decode"],
                     bf16_rrms=flash_err["bf16_rrms"]["decode"],
                     **{k: fl["decode"][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "library_eager_ms")}),
                 "simt": dict(
                     source="src/repro_torch/csrc/flash_attention.cu",
                     launches=lm["launches"]["flash_simt"],
                     cases=flash_err["cases"]["simt"],
                     bf16_rrms=flash_err["bf16_rrms"]["simt"],
                     ms={"prefill": fl["prefill"]["simt_ms"],
                         "decode": fl["decode"]["simt_ms"]},
                     bound_ms={"prefill": fl["prefill"]["bound_ms"],
                               "decode": fl["decode"]["bound_ms"]})}),
        dict(name="fused_expand_q", route="cuda",
             source="src/repro_torch/csrc/fused_expand_q.cu",
             replaces="src/repro/kernels/fused_expand_q.py:110",
             also_replaces="src/repro/kernels/fused_expand_q.py:179",
             launches=q["launches"],
             max_abs_err=max(err["fused_expand_q"], q["max_abs_err"]),
             ms=q["dense_ms"], plain_ms=q["plain_ms"],
             bound_ms=q["dense_bound_ms"], bound_by=q["dense_bound_by"],
             library_ms=None,
             compacted={"ms": q["compact_ms"],
                        "bound_ms": q["compact_bound_ms"],
                        "bound_by": q["compact_bound_by"],
                        "compaction_ms": q["compaction_ms"]},
             slot_list=dict({k: q[f"slot_{k}"] for k in (
                 "entries", "bytes", "build_ms")},
                 cell_collisions=q["cell_collisions"])),
    ]
    print(json.dumps({"kernels": kernels}))
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
