"""The program's own spans and counters (``repro_torch.tracing``) over a
traced run's profiled slice, as the per-layer readers need them: time
summed by span name, the time of children inside a parent, counts.

The program records while a profiler runs, so after the slice of a
``--trace 1`` run its registry holds that slice and nothing else.  `of`
takes it once a record, keeps it under ``rec["program_spans"]`` and
empties the registry, so a later run in the same process starts empty.  A
record that already holds a snapshot is read as it is; a program without
the registry (an older checkout) gives None, and so every reader here.
"""
from __future__ import annotations

KEY = "program_spans"


class Spans:
    """Sums over one registry snapshot (``{"spans": [(name, start_ns,
    end_ns, parent, rid)], "counters": {...}, "dropped": n}``)."""

    def __init__(self, snap: dict):
        self.spans = list(snap.get("spans", ()))
        self.counters = dict(snap.get("counters", {}))

    def _inside(self, span, parent: str | None) -> bool:
        return parent is None or (span[3] is not None
                                  and self.spans[span[3]][0] == parent)

    def seconds(self, name: str, parent: str | None = None,
                outside: str | None = None) -> float:
        """Summed length of the ``name`` spans, only those directly inside
        a ``parent`` span, or only those not directly inside an
        ``outside`` span."""
        return 1e-9 * sum(
            s[2] - s[1] for s in self.spans
            if s[0] == name and self._inside(s, parent)
            and (outside is None or not self._inside(s, outside)))

    def count(self, name: str) -> int:
        return sum(s[0] == name for s in self.spans)

    def counter(self, name: str) -> int | None:
        return self.counters.get(name)


def of(rec: dict) -> Spans | None:
    """The run's spans, or None where the program keeps none."""
    if KEY not in rec:
        try:
            from repro_torch import tracing
        except ImportError:
            rec[KEY] = None
        else:
            rec[KEY] = tracing.snapshot()
            tracing.reset()
    return None if rec[KEY] is None else Spans(rec[KEY])
