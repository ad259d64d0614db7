"""A ``--trace 1`` run of a benchmark cell, with its device idle put down to
the program's spans.

    PYTHONPATH=src:. python scripts/bpt_trace_gaps.py OUT.json \
        --workload <cell> --seed <n> --seconds <s>

Runs `bpt_bench.run.main` with ``--trace 1`` and the arguments given, and
reads more from the profiled slice than the result line does:

* ``device_names_program``: device events named like a program span
  (``store.``, ``sampler.``, ``frontier.``, ``level``, ``batcher.``,
  ``engine.``); empty when no span has a device copy;
* ``cpu_span_sums_s``: [seconds, count] of each program span and of the
  benchmark's own spans, from the profiler's CPU events;
* ``idle_by_innermost_program_span_s``: every idle gap of the device,
  [seconds, gaps], by the innermost program span open at the gap's
  middle (``outside`` where none is);
* ``gaps_ms_open``: the 25 longest gaps in ms, each with every CPU event
  open at its middle, outermost first;
* ``registry``: the program registry's [seconds, count] by span name, its
  counters and drops, and the slice's ``window_s``.

Writes these to ``OUT.json``, prints them but the gaps on one ``EXTRA``
line and the 12 longest gaps on a ``GAPS`` line; the exit code is the
run's.
"""
from __future__ import annotations

import json
import sys

import torch

from bpt_bench import run, spans, trace

PROGRAM = ("store.", "sampler.", "frontier.", "level", "batcher.", "engine.")
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

extra: dict = {}
_summary = trace.Tracer.summary
_of = spans.of


def _by_innermost(prog, gaps) -> dict:
    """Idle [seconds, gaps] by the innermost of the nested ``prog`` ranges
    (sorted by start) open at each gap's middle: one sweep with a stack."""
    mids = sorted(((a + b) / 2, g) for g, a, b in gaps)
    by, stack, k = {}, [], 0
    for t, g in mids:
        while k < len(prog) and prog[k][0] <= t:
            while stack and stack[-1][1] < prog[k][0]:
                stack.pop()
            stack.append(prog[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        v = by.setdefault(stack[-1][2] if stack else "outside", [0.0, 0])
        v[0] += g * 1e-6
        v[1] += 1
    return dict(sorted(by.items(), key=lambda kv: -kv[1][0]))


def summary(self) -> dict:
    out = _summary(self)
    if self._prof is None:
        return out
    events = list(self._prof.events())
    cpu = [(float(e.time_range.start), float(e.time_range.end), e.name)
           for e in events if e.device_type == CPU]
    device: dict = {}
    for e in events:
        if e.device_type == CUDA:
            device.setdefault(e.device_index, []).append(
                (float(e.time_range.start), float(e.time_range.end), e.name))
    extra["device_names_program"] = sorted(
        {n for items in device.values() for _, _, n in items
         if n.startswith(PROGRAM)})
    sums: dict = {}
    for s, e, n in cpu:
        if n.startswith(PROGRAM) or n in trace.SPANS:
            v = sums.setdefault(n, [0.0, 0])
            v[0] += (e - s) * 1e-6
            v[1] += 1
    extra["cpu_span_sums_s"] = sums
    gaps = []
    for items in device.values():
        gaps += trace._busy_and_gaps(
            [i for i in items if i[2] not in trace.SPANS])[1]
    gaps.sort(reverse=True)
    extra["gaps_ms_open"] = [
        [round(g * 1e-3, 4),
         [n for _, _, n in sorted(c for c in cpu
                                  if c[0] <= (a + b) / 2 <= c[1])]]
        for g, a, b in gaps[:25]]
    prog = sorted(c for c in cpu if c[2].startswith(PROGRAM))
    extra["idle_by_innermost_program_span_s"] = _by_innermost(prog, gaps)
    extra["idle_s"] = sum(g for g, _, _ in gaps) * 1e-6
    return out


def of(rec: dict):
    s = _of(rec)
    if s is not None and "registry" not in extra:
        names: dict = {}
        for n, a, b, _, _ in s.spans:
            v = names.setdefault(n, [0.0, 0])
            v[0] += (b - a) * 1e-9
            v[1] += 1
        extra["registry"] = {
            "sums_s": names, "counters": s.counters,
            "dropped": rec[spans.KEY]["dropped"],
            "window_s": (rec.get("trace") or {}).get("window_s")}
    return s


def main(argv: list[str]) -> int:
    out_path, args = argv[0], argv[1:]
    trace.Tracer.summary = summary
    spans.of = of
    rc = run.main(args + ["--trace", "1"])
    with open(out_path, "w") as f:
        json.dump(extra, f, indent=1)
    print("EXTRA " + json.dumps({k: v for k, v in extra.items()
                                 if k != "gaps_ms_open"}))
    print("GAPS " + json.dumps(extra.get("gaps_ms_open", [])[:12]))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
