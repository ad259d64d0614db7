"""Spans and counters inside the program, on the torch profiler's timeline.

``span(name, rid=None)`` marks a stretch of host work; ``count(name, n)``
adds to a named counter.  Both record only while a ``torch.profiler``
profile runs.  Otherwise ``span`` returns one shared object whose ``with``
does nothing, after one flag check, and ``count`` returns.

A recorded span does two things:

* it opens a CPU range of the profiler's ``FUNCTION`` scope
  (``_RecordFunctionFast``), so the span lies on the same timeline as the
  device's kernels, and has no device-side copy (``record_function``'s
  user scope gets one, which would read as device time);
* when it closes, it keeps ``(name, start_ns, end_ns, parent, rid)`` in
  memory, with ``time.perf_counter_ns`` times.  ``parent`` is the span
  open around it on the same thread (the query front flushes from other
  threads), ``rid`` the request it serves: a span without one takes its
  parent's.

The registry keeps what it records until ``reset()``: a server profiled
for a long time stops keeping spans once it holds ``CAP`` of them (~215
bytes each, 14 MB), and counts the rest as dropped.  An operator reads
it after a profile::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        store.refresh(0.25)
    snap = tracing.snapshot()       # {"spans", "counters", "dropped"}
    tracing.reset()

Spans of the pool refresh: ``store.refresh`` > ``sampler.batch`` (rid:
the batch index) > ``sampler.setup`` (roots and seed), ``frontier.init``
(the first frontier, padded; visited zeroed), ``level.sync`` (the first
frontier's test) and one ``level`` a BFS level > ``level.compact`` (the
sparse frontier's tile list), ``level.expand`` (the level's launches: the
OR into visited, the kernel, the test of the next frontier) and
``level.sync`` (only the blocking read of that test); then
``store.update`` (the stacked masks' new slots).  Counters:
``sampler.levels`` and ``sampler.syncs`` (every blocking device read of a
batch).

Spans of the query flush: ``batcher.flush`` (rid: the flush's sequence
number) > ``batcher.lookup`` (the result cache, under the lock),
``engine.pad``, ``engine.sigma`` and ``engine.marginal`` (each >
``.count``, the launches; ``.read``, the blocking copy of the counts;
``.scale``, float64 and n/θ), ``engine.top_k``, ``batcher.store`` (cache
puts and the results' fan-out).
"""
from __future__ import annotations

import itertools
import threading
import time

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["CAP", "span", "count", "snapshot", "reset"]

CAP = 2 ** 16               # a traced benchmark slice keeps ~25,000

_lock = threading.Lock()
_spans: list[tuple] = []         # (id, name, start_ns, end_ns, parent id, rid)
_ids = itertools.count()
_now = time.perf_counter_ns
_counters: dict[str, int] = {}
_dropped = 0


class _Local(threading.local):
    def __init__(self):
        self.stack: list[_Span] = []


_local = _Local()


class _Off:
    """The span while recording is off.  ``"".format`` is a C function
    that takes any arguments and returns a false value, so neither call
    of the ``with`` runs Python code and an exception passes through."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_rid", "_id", "_parent", "_start", "_range",
                 "_stack")

    def __init__(self, name: str, rid):
        self._name = name
        self._rid = rid

    def __enter__(self):
        stack = self._stack = _local.stack
        if stack:
            top = stack[-1]
            self._parent = top._id
            if self._rid is None:
                self._rid = top._rid
        else:
            self._parent = None
        self._id = next(_ids)
        self._range = _RecordFunctionFast(self._name)
        self._range.__enter__()
        self._start = _now()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _dropped
        end = _now()
        self._stack.pop()
        self._range.__exit__(*exc)
        # A tuple of numbers and strings, which the collector stops
        # tracking; ``append`` is atomic, so only a drop takes the lock.
        if len(_spans) < CAP:
            _spans.append((self._id, self._name, self._start, end,
                           self._parent, self._rid))
        else:
            with _lock:
                _dropped += 1


def span(name: str, rid=None):
    """A context manager marking ``name`` (see the module docstring)."""
    if _profiler._is_profiler_enabled:
        return _Span(name, rid)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """``{"spans": [(name, start_ns, end_ns, parent, rid)], "counters":
    {name: n}, "dropped": n}``: closed spans in the order they opened,
    ``parent`` an index into the list (None for a span with none kept)."""
    with _lock:
        recs = sorted(_spans)
        counters = dict(_counters)
        dropped = _dropped
    index = {r[0]: i for i, r in enumerate(recs)}
    spans = [(name, start, end, index.get(parent), rid)
             for _, name, start, end, parent, rid in recs]
    return {"spans": spans, "counters": counters, "dropped": dropped}


def reset() -> None:
    """Forget every span, counter and drop so far."""
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0
