"""A profiled slice of a run's window: device time by kernel, the device's
busy time, and the longest idle gaps named by what the host was doing.

``torch.profiler`` records the CPU ops, the benchmark's spans
(``record_function``) and, through CUPTI, every kernel, copy and memset
on the card.  The slice starts and ends on a synchronised device, so its
host-clock length is the traced window.  A device's busy time is the
union of its intervals (kernels, copies, memsets; the profiler's
device-side copies of the spans are left out), averaged over the devices
the run used; an idle gap is a stretch between two intervals of one
device.
"""
from __future__ import annotations

import time

import torch

SPANS = ("refresh", "flush", "TiledSampler.sample")
TOP = 10


def _intervals(prof):
    """({device index: [(start_us, end_us, name)]}, cpu list of the same)."""
    device, cpu = {}, []
    for ev in prof.events():
        tr = ev.time_range
        item = (float(tr.start), float(tr.end), ev.name)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name not in SPANS:     # not the spans' device mirrors
                device.setdefault(ev.device_index, []).append(item)
        elif ev.device_type == torch.autograd.DeviceType.CPU:
            cpu.append(item)
    return device, cpu


def _busy_and_gaps(items):
    """The union's length of ``items`` and its gaps (length, start, end),
    in us."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in sorted(items):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


class Tracer:
    """One profiled slice (``start``/``stop``), read by ``summary``."""

    def __init__(self, devices: list):
        self.devices = devices
        self._prof = None
        self._t0 = self._t1 = None
        self.window_s = 0.0

    def _sync(self):
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.devices[0].type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Profile one small op, so the first real slice pays no set-up."""
        with self._profile():
            for d in self.devices:
                torch.ones(8, device=d).sum().item()
        self._sync()

    @property
    def active(self) -> bool:
        return self._prof is not None and self._t1 is None

    def start(self) -> None:
        self._sync()
        self._prof = self._profile()
        self._prof.__enter__()
        self._t1 = None
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self._t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.window_s = self._t1 - self._t0

    def summary(self) -> dict:
        """``window_s``, ``busy_s``, ``kernels`` {name: [seconds, launches]},
        ``device_ops`` and ``idle_gaps`` (the ten largest of each, as
        [name, seconds])."""
        if self._prof is None:
            return {}
        device, cpu = _intervals(self._prof)
        kernels: dict[str, list] = {}
        busy, gaps = 0.0, []
        for items in device.values():
            for s, e, name in items:
                k = kernels.setdefault(name, [0.0, 0])
                k[0] += (e - s) * 1e-6
                k[1] += 1
            b, g = _busy_and_gaps(items)
            busy += b / len(self.devices)
            gaps += g
        gaps.sort(reverse=True)
        idle = [[_host_label(cpu, (a + b) / 2), g * 1e-6]
                for g, a, b in gaps[:TOP]]
        ops = sorted(((v[0], n) for n, v in kernels.items()), reverse=True)
        return {"window_s": self.window_s, "busy_s": busy * 1e-6,
                "kernels": kernels,
                "device_ops": [[n, t] for t, n in ops[:TOP]],
                "idle_gaps": idle}


def _host_label(cpu, t: float) -> str:
    """The benchmark's spans open at ``t``, outermost first, then the
    innermost host op there."""
    open_ = [(s, e, n) for s, e, n in cpu if s <= t <= e]
    spans = [n for s, e, n in sorted(open_) if n in SPANS]
    others = [(e - s, n) for s, e, n in open_ if n not in SPANS]
    inner = min(others)[1] if others else "host"
    return ">".join(spans + [inner])
