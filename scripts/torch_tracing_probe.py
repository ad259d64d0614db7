"""What a `repro_torch.tracing` span costs, off and recording, and whether
it gets a device copy under a CUDA profile.

    PYTHONPATH=src python scripts/torch_tracing_probe.py

On the card: a CUDA profile around a ``record_function`` range holding
two program spans and a kernel, then the names of the device events (the
user range has a copy there; a program span should not).  Then ``timeit``
minima, ns a call, of an empty Python call, a span off (with and without
a rid), ``count`` off, the profiler's flag alone, ``_RecordFunctionFast``
and ``record_function`` off, and a span, ``_RecordFunctionFast`` and
``record_function`` under a CPU profile and under a CPU and CUDA profile;
and the bytes 200,000 spans off allocate.  Runs on the CPU too, without
the device part.
"""
from __future__ import annotations

import json
import sys
import timeit
import tracemalloc

import torch
import torch.autograd.profiler as P

from repro_torch import tracing

PA = torch.profiler.ProfilerActivity


def device_copies() -> None:
    dev = torch.device("cuda", 0)
    x = torch.ones(1 << 22, device=dev)
    (x * 2).sum().item()
    for _ in range(2):                      # the first profile warms up
        with torch.profiler.profile(activities=[PA.CPU, PA.CUDA]) as prof:
            with torch.profiler.record_function("probe.user"):
                with tracing.span("probe.span", 1):
                    with tracing.span("probe.inner"):
                        (x * 2).sum().item()
            torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    cpu = {e.name: e.is_user_annotation for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.name.startswith("probe")}
    print("device event names:", names)
    print("cpu probe events, is_user_annotation:", cpu)
    print("device copy: probe.user", "probe.user" in names,
          "probe.span", "probe.span" in names,
          "probe.inner", "probe.inner" in names)
    tracing.reset()


def empty():
    pass


def span():
    with tracing.span("level"):
        pass


def span_rid():
    with tracing.span("sampler.batch", 3):
        pass


def count():
    tracing.count("sampler.levels", 5)


def flag():
    P._is_profiler_enabled


def fast():
    with torch._C._profiler._RecordFunctionFast("level"):
        pass


def user():
    with torch.profiler.record_function("level"):
        pass


def best(fn, n: int, repeat: int = 7) -> float:
    return min(timeit.repeat(fn, number=n, repeat=repeat)) / n * 1e9


def main() -> None:
    cuda = torch.cuda.is_available()
    print("torch", torch.__version__, torch.version.cuda,
          sys.version.split()[0])
    if cuda:
        device_copies()
    res = {fn.__name__ + "_off": best(fn, n) for fn, n in (
        (empty, 2_000_000), (span, 2_000_000), (span_rid, 2_000_000),
        (count, 2_000_000), (flag, 2_000_000), (fast, 200_000),
        (user, 50_000))}
    profiles = {"cpu": [PA.CPU]}
    if cuda:
        profiles["cuda"] = [PA.CPU, PA.CUDA]
    for tag, acts in profiles.items():
        for fn in (span, fast, user):
            with torch.profiler.profile(activities=acts):
                res[f"{fn.__name__}_{tag}_profile"] = best(fn, 20_000, 3)
            tracing.reset()
    tracemalloc.start()
    for _ in range(1000):
        span()
    before = tracemalloc.take_snapshot()
    for _ in range(200_000):
        span()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    res["span_off_bytes_200k"] = sum(
        d.size_diff for d in after.compare_to(before, "filename"))
    print("ns a call:", json.dumps({k: round(v, 1) for k, v in res.items()}))
    print("a span off beyond an empty call (ns):",
          round(res["span_off"] - res["empty_off"], 1))


if __name__ == "__main__":
    main()
