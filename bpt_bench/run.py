"""Run one cell of the benchmark once.

    python3 bpt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``bpt_bench/``
and the port (``src/repro_torch``).  The cell names its configuration and
traffic mix (`bpt_bench.spec`); the mix's loop (``bpt_bench/loops``) makes
the inputs from the seed, sets the program up and warms it, measures for
``--seconds`` and keeps a sample of what the window produced.  Then the
sample is compared with the plain reference (``bpt_bench/reference``),
and the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a profiled slice of the
window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit (also the last lines of
standard error).

It needs a CUDA device (as many as the cell's ``chips``) and exits with
code 2 and no result without one.  The kernels build into
``build/torch_kernels`` inside the checkout; every other cache goes there
too or under the run's ``HOME``, ``XDG_CACHE_HOME`` or ``TMPDIR``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# Caches at fixed paths inside the checkout (the kernels' own build
# directory is build/torch_kernels, fixed by the program).
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             devices: list, config: dict | None = None,
             traffic: dict | None = None, t_start: float = T_START) -> dict:
    """One run of cell ``name`` on ``devices`` (the cell's ``chips``);
    ``config`` and ``traffic`` override the cell's files (the CPU tests'
    small sizes).  The loop's set-up says which devices it used, and the
    result reports those."""
    import torch

    from bpt_bench import check, spec
    from bpt_bench.trace import Tracer

    cell = spec.cell(bench, name)
    config = config if config is not None else spec.config(cell["config"])
    traffic = traffic if traffic is not None else spec.traffic(
        cell["traffic"])
    loop = spec.loop(traffic["loop"])
    st = loop.setup(config, traffic, seed, devices)
    used = st.devices
    cuda = used[0].type == "cuda"
    tracer = None
    if trace:
        tracer = Tracer(used)
        tracer.warm()
    rec = loop.window(st, seconds, tracer)
    if cuda:
        for d in used:
            torch.cuda.synchronize(d)
    rec["setup_s"] = rec["t0"] - t_start
    t_closed = time.perf_counter()
    peak = max(torch.cuda.max_memory_allocated(d) for d in used) \
        if cuda else 0
    section = "per_layer" if trace else "end_to_end"
    if trace:
        rec["trace"] = tracer.summary()
        loop.layer_record(st, rec)
    metrics = {}
    for m in spec.metrics_of(bench, name, section):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    loop.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_verify = time.perf_counter()
    checks, attempted, failed = loop.verify(st, rec)
    print(f"bpt_bench: set-up {rec['setup_s']:.2f} s, window "
          f"{rec['window_s']:.2f} s, reading {t_verify - t_closed:.2f} s, "
          f"reference {time.perf_counter() - t_verify:.2f} s",
          file=sys.stderr)
    out = {"correct": check.passed(checks) and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else used[0].type,
                      "kind": torch.cuda.get_device_name(used[0]) if cuda
                      else used[0].type,
                      "count": len(used), "memory_peak_bytes": peak}}
    if trace:
        t = rec["trace"]
        out["device"]["busy_s"] = t.get("busy_s", 0.0)
        out["device"]["window_s"] = t.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": t.get("device_ops", []),
                            "idle_gaps": t.get("idle_gaps", [])}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bpt_bench import spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"bpt_bench: cell {args.workload} needs {cell['chips']} CUDA "
              "device(s); none or too few here", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(int(cell["chips"]))]
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), devices)
    bad = forbidden_modules()
    if bad:
        print(f"bpt_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
