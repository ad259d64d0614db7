"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (the kernels are built for ``sm_90a``) and the
CUDA toolkit's ``nvcc``; it exits non-zero, printing no result, anywhere
else.  Phases, each of which raises on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: both kernels from ``src/repro_torch/csrc``, compiled in parallel;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   exact equality — ``fused_expand`` on a reduced graph (empty frontier,
   destination blocks no tile reaches, ``pad_tiles_to`` padding tiles, 32/64/
   96 colours), ``cover_counts`` at the full pool shape;
4. main path at full size: the serving launcher's ``run_single`` on the
   kernel backend — powerlaw_cluster(65,536, 6.0, p=0.25, seed 7), 64
   colours, a 64-batch pool (4,096 RRR sets), one mixed micro-batched flush
   (top-16, 6 σ, 6 marginal), the same flush as 100% cache hits, a 25%
   refresh, and offline ``run_imm`` (ε 0.5, θ ≤ 4,096) through a fresh pool
   and without one, both equal to the host-loop greedy.  The launch counters
   are zeroed just before and read just after; both kernels must have run;
5. golden: batches 0-3 on the kernel backend, and 0-1 on the dense CSR
   backend, bit for bit against ``tests/data/torch_port_golden.json`` (made
   by ``scripts/make_torch_golden.py`` from the JAX reference), plus the
   top-16 seeds over that 4-batch pool;
6. timing (CUDA events): every level of batch 0 through the kernel and
   through the plain version (equal at every level), and ``cover_counts``
   at the pool's shape, each beside its bound on this card.

The line before the last is the card's name and power limit as
``nvidia-smi`` reports them; the last line is the result object.
"""
from __future__ import annotations

import hashlib
import json
import os
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
# Integer operations of the counter hash (core/rng.py): one fold is
# 2 shifts + 3 adds + 1 xor, then mix32 is 3 shift-xor pairs + 2 multiplies;
# a colour draw adds shift, convert, scale and compare.
OPS_PER_EDGE_FOLD = 14
OPS_PER_DRAW = 18


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
def check_kernels(dev) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest word difference seen per kernel (0 = bit-identical)."""
    from repro_torch.core import tiles
    from repro_torch.graph import csr
    from repro_torch.kernels import ops, ref

    err = {"fused_expand": 0, "cover_counts": 0}
    rs = np.random.default_rng(11)
    n, e = 4096, 40_000
    src = rs.integers(0, n, e)
    dst = rs.integers(0, 3000, e)        # blocks 24..31 receive no tile
    keep = src != dst
    g = csr.from_edges(src[keep], dst[keep],
                       rs.uniform(0, 1, keep.sum()).astype(np.float32), n,
                       dedupe=True, device=dev)
    nt = tiles.from_graph(g).num_tiles
    tg = tiles.from_graph(g, pad_tiles_to=nt + 5)
    ptr = tg.dst_run_ptr
    _check(bool((ptr[1:] == ptr[:-1]).any()), "reduced graph lacks empty "
           "destination blocks")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = 0
    for colors in (32, 64, 96):
        for density in (0.0, 0.02, 0.3):
            fr, vis = _random_masks(tg.padded_vertices, colors, density, gen,
                                    dev)
            for seed, level in ((1, 0), (0xDEADBEEF, 17)):
                got = ops.fused_expand(tg, fr, vis, seed, level)
                want = ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                            tg.tile_dst, fr, vis, seed, level)
                torch.cuda.synchronize()
                err["fused_expand"] = max(err["fused_expand"],
                                          _max_abs_err(got, want))
                _check(density > 0 or not bool(got.any()),
                       "empty frontier expanded")
                cases += 1
    print(f"[kernels] fused_expand: {cases} cases on a {n}-vertex graph "
          f"({tg.num_tiles} tiles, 5 padding), max word diff "
          f"{err['fused_expand']}")
    for b, v, w in ((64, 65536, 2), (16, 65536, 3), (1, 300, 1)):
        vis = torch.randint(-2 ** 31, 2 ** 31, (b, v, w), dtype=torch.int32,
                            device=dev, generator=gen)
        act = torch.randint(-2 ** 31, 2 ** 31, (b, w), dtype=torch.int32,
                            device=dev, generator=gen)
        got = ops.cover_counts(vis, act)
        want = ref.cover_counts_ref(vis, act)
        err["cover_counts"] = max(err["cover_counts"],
                                  _max_abs_err(got, want))
    print(f"[kernels] cover_counts: (B, V, W) up to (64, 65536, 2), max diff "
          f"{err['cover_counts']}")
    _check(err == {"fused_expand": 0, "cover_counts": 0},
           f"kernel disagrees with its plain version: {err}")
    return err


def run_main_path(golden: dict) -> tuple[dict, dict]:
    """The serving launcher at full size on the kernel backend; returns its
    summary and the launch counts of exactly this run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_influence

    args = serve_influence.parse_args([
        "--device", "cuda", "--smoke", "--sampler-backend", "kernel",
        "--n", str(golden["graph"]["n"]), "--colors", "64",
        "--batches", "64", "--max-batches", "64", "--k", "16",
        "--queries", "6", "--theta-cap", "4096"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve_influence.run_single(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"[main] launches on the main path: {launches}")
    _check(all(launches[k] > 0 for k in ("fused_expand", "cover_counts")),
           f"a kernel of the path never launched: {launches}")
    return out, launches


def check_outputs(out: dict, golden: dict) -> None:
    """Shapes, finiteness and the full-size golden values."""
    from repro_torch.core import imm
    from repro_torch.sampling import SamplerSpec, make_sampler

    store = out["store"]
    tg = store.sampler.tg_rev
    n = store.graph.num_vertices
    print(f"[main] graph: {n} vertices, {store.graph.num_edges} edges, "
          f"{tg.num_tiles} tiles; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
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
    print("[golden] kernel batches 0-3, dense batches 0-1 and the top-16 "
          "seeds equal the reference bit for bit "
          f"(fused edge visits {[d.fused_edge_visits for d in dense]})")


def time_fused_expand(store) -> dict:
    """Every level of batch 0 through the kernel and the plain version."""
    from repro_torch.core import bitmask, tiles, traversal
    from repro_torch.kernels import ops, ref

    tg, g_rev = store.sampler.tg_rev, store.g_rev
    dev = tg.prob.device
    seed = store.sampler.batch_seed(0)
    fr = tiles.pad_mask_rows(traversal.init_frontier(
        tg.num_vertices, 64, store.sampler.batch_starts(0), dev),
        tg.padded_vertices)
    vis = torch.zeros_like(fr)
    src = g_rev.src[:g_rev.num_edges].long()
    dst = g_rev.dst[:g_rev.num_edges].long()
    kernel_ms, plain_ms, bytes_ms, ops_ms, err = [], [], [], [], 0
    level = 0
    while level < 64 and bitmask.any_set(fr):
        vis = vis | fr
        nf = ops.fused_expand(tg, fr, vis, seed, level)          # warm
        kernel_ms.append(_time_ms(
            lambda: ops.fused_expand(tg, fr, vis, seed, level), 2))
        want = [None]

        def plain():
            want[0] = ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                           tg.tile_dst, fr, vis, seed, level)
        plain_ms.append(_time_ms(plain, 1))
        err = max(err, _max_abs_err(nf, want[0]))
        # What this level's data needs: the prob and edge id of each edge
        # whose source row is live, the three masks, the tile indices; one
        # edge fold per live edge and one draw per colour that can cross it.
        fr_src = fr[src]
        live = (fr_src != 0).any(1)
        draws = int(bitmask.popcount(fr_src[live] & ~vis[dst[live]]).sum())
        n_live = int(live.sum())
        nbytes = (n_live * 8 + 3 * fr.numel() * 4 + tg.num_tiles * 4
                  + tg.dst_run_ptr.numel() * 4)
        bytes_ms.append(1e3 * nbytes / HBM_BYTES_PER_S)
        ops_ms.append(1e3 * (n_live * OPS_PER_EDGE_FOLD + draws * OPS_PER_DRAW)
                      / SCALAR_OPS_PER_S)
        fr = nf
        level += 1
    _check(err == 0, f"fused_expand differs from its plain version at full "
           f"size: max word diff {err}")
    bound = np.maximum(bytes_ms, ops_ms)
    per = dict(levels=level, ms=float(np.mean(kernel_ms)),
               plain_ms=float(np.mean(plain_ms)),
               bound_ms=float(np.mean(bound)), max_abs_err=err,
               bound_by=("bytes" if np.sum(bytes_ms) >= np.sum(ops_ms)
                         else "operations"),
               ms_max=float(np.max(kernel_ms)))
    print(f"[timing] fused_expand over the {level} levels of batch 0: kernel "
          f"mean {per['ms']:.4f} ms (max {per['ms_max']:.4f}), plain "
          f"{per['plain_ms']:.4f} ms, bound {per['bound_ms']:.6f} ms "
          f"({per['bound_by']}; bytes {np.mean(bytes_ms):.6f}, operations "
          f"{np.mean(ops_ms):.6f})")
    print(f"[timing] fused_expand ms per level: "
          f"{[round(t, 3) for t in kernel_ms]}")
    # Host clock around the whole batch: the kernel's share of it is how
    # busy the per-level loop keeps the card.
    t0 = time.perf_counter()
    store.sampler.sample(0)
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[timing] batch 0 end to end {batch_ms:.2f} ms; its levels' kernel "
          f"times sum to {np.sum(kernel_ms):.2f} ms "
          f"({np.sum(kernel_ms) / batch_ms:.1%})")
    return per


def time_cover_counts(store) -> dict:
    """cover_counts at the pool's shape, L2 flushed before each launch (the
    greedy loop's first pick; later picks find the stack in L2 — printed as
    ``warm``)."""
    from repro_torch.core import imm
    from repro_torch.kernels import ops, ref

    vis = store.visited_stack()
    b, v, w = vis.shape
    act = imm.initial_active(b, store.num_colors, vis.device)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=vis.device)
    ops.cover_counts(vis, act)
    cold = _time_ms(lambda: ops.cover_counts(vis, act), 50, flush.zero_)
    warm = _time_ms(lambda: ops.cover_counts(vis, act), 200)
    plain = _time_ms(lambda: ref.cover_counts_ref(vis, act), 10,
                     flush.zero_)
    err = _max_abs_err(ops.cover_counts(vis, act),
                       ref.cover_counts_ref(vis, act))
    # Each visited word read once, the active words once, the counts
    # written once; and, popcount and add per word.
    bytes_ms = 1e3 * (b * v * w + b * w + v) * 4 / HBM_BYTES_PER_S
    ops_ms = 1e3 * 3 * b * v * w / SCALAR_OPS_PER_S
    _check(err == 0, f"cover_counts differs from its plain version: {err}")
    per = dict(ms=cold, warm_ms=warm, plain_ms=plain,
               bound_ms=max(bytes_ms, ops_ms), max_abs_err=err,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f"[timing] cover_counts (B, V, W)=({b}, {v}, {w}): kernel cold "
          f"{cold:.4f} ms, warm {warm:.4f} ms, plain {plain:.4f} ms, bound "
          f"{per['bound_ms']:.4f} ms ({per['bound_by']})")
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
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    with open(GOLDEN) as f:
        golden = json.load(f)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} in {build_s:.2f}s")
    for name in _build.SOURCES:
        regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {regs[-1] if regs else 'no ptxas report'}")

    err = check_kernels(dev)
    out, launches = run_main_path(golden)
    check_outputs(out, golden)
    fe = time_fused_expand(out["store"])
    cc = time_cover_counts(out["store"])

    build_pool_s = out["build_s"]
    print(f"[result] build {build_s:.2f}s; pool build {build_pool_s:.3f}s "
          f"for 64 batches ({64 / build_pool_s:.2f} batches/s); mixed flush "
          f"{out['flush_s'] * 1e3:.2f} ms (first in the process), "
          f"{out['reflush_s'] * 1e3:.2f} ms (after the refresh); "
          f"fused_expand mean per level "
          f"{fe['ms']:.4f} ms; cover_counts {cc['ms']:.4f} ms; total "
          f"{time.time() - t_all:.1f}s")
    kernels = [
        dict(name="fused_expand", route="cuda",
             source="src/repro_torch/csrc/fused_expand.cu",
             replaces="src/repro/kernels/fused_expand.py:99",
             launches=launches["fused_expand"],
             max_abs_err=max(err["fused_expand"], fe["max_abs_err"]),
             ms=fe["ms"], plain_ms=fe["plain_ms"], bound_ms=fe["bound_ms"],
             bound_by=fe["bound_by"], library_ms=None),
        dict(name="cover_counts", route="cuda",
             source="src/repro_torch/csrc/coverage.cu",
             replaces="src/repro/kernels/coverage.py:41",
             launches=launches["cover_counts"],
             max_abs_err=max(err["cover_counts"], cc["max_abs_err"]),
             ms=cc["ms"], plain_ms=cc["plain_ms"], bound_ms=cc["bound_ms"],
             bound_by=cc["bound_by"], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
