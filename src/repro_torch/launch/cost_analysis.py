"""Per-device cost of one rank's program, counted as it runs on meta tensors
(the port's counterpart of ``repro.launch.hlo_analysis``).

The reference compiles each cell and walks XLA's HLO text after SPMD
partitioning: loop-weighted FLOPs of every ``dot``, HBM bytes of every
top-level op, and collective bytes.  The port has no HLO: a rank runs
eager PyTorch on its own shards.  `full_cost` runs that program with
meta tensors under a ``TorchDispatchMode`` that sees every aten op, and
counts:

* **FLOPs**: ``torch.utils.flop_counter``'s formulas for the aten
  products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  attention), the counterpart of the reference's ``dot``-only count, plus
  the operations the hand-written kernels report from their meta
  branches (`kernels.ops`, by the bound column's formulas,
  `kernels.work`; ``kernels`` holds them by kernel).
* **HBM bytes**: the operand and result bytes of every aten op (a
  broadcast operand at most its storage's), views and aliases skipped
  (as the parser's ``_ALIAS_OPS``), and allocations that write nothing
  (``empty``) too; the kernels report their own.
  Eager PyTorch fuses nothing, so this is what the card's program moves,
  where the reference's count is that of XLA's fusions.  Each collective
  adds its result bytes twice (read and written), as the parser does.
* **collective bytes**: from the mesh's log (`comm.Mesh.collective_log`,
  kept by the dry-run's `comm.ShapeMesh` alike): result bytes times the
  reference's factor (all-reduce 2×, a ring sends and receives every
  byte twice; the others 1×), ``op_counts`` by kind and ``by_axis``
  equal to the mesh's ``stats``.
* **peak bytes**: the most meta storage bytes live at once, each storage
  counted from the op that makes it until its last tensor is freed
  (``weakref.finalize``); ``argument_bytes`` are those live at entry (the
  arguments' tensors).

Loops are counted as they run: a microbatch loop, a remat recompute or a
layer loop is traced each time it runs, the exact form of the parser's
trip-count weighting.  What it cannot do: a loop whose trip count
depends on the data (a traversal's level loop) cannot run on meta
tensors, which hold none; the dry-run traces one level of it and says
so (the parser counts a dynamic ``while`` once, for the same reason).
XLA's fusion, rematerialisation and buffer reuse have no counterpart:
the peak is the eager allocator's, not a compiler's.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

# The reference's collective names and factors (all-reduce 2×).
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "ppermute": "collective-permute", "broadcast": "broadcast"}
FACTOR = {"all-reduce": 2.0}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _tensors(x, out: list) -> list:
    """Every tensor of a nested argument (tensors, dicts, lists, tuples,
    modules' parameters and buffers, dataclasses)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, nn.Module):
        out.extend(x.parameters())
        out.extend(x.buffers())
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements', but no
    more than its storage holds (a broadcast view reads each element of
    its storage, not each of its positions)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CostCounter(TorchDispatchMode):
    """The dispatch mode of `full_cost` (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: dict = {}
        self.live: dict = {}          # storage → [bytes, tensors]
        self.current = self.peak = 0

    def track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.current += entry[0]
            self.peak = max(self.peak, self.current)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.current -= entry[0]
            del self.live[key]

    def kernel(self, name: str, operations: float, nbytes: float) -> None:
        """A kernel's meta call (`kernels.ops.COST_SINKS`)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += operations
        k["bytes"] += nbytes
        self.flops += operations
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        outs = _tensors(out, [])
        if not _is_view(func) and packet.__name__ not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs),
                                                           []))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            if t.device.type == "meta":
                self.track(t)
        return out


def full_cost(fn, *args, mesh=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` on meta tensors under a `CostCounter`
    and return its per-device cost (module docstring): ``flops``,
    ``bytes``, ``collective`` (``per_device_bytes``, ``by_kind``,
    ``op_counts``, ``by_axis``; from ``mesh``, whose counts are reset
    first), ``peak_bytes``, ``argument_bytes``, ``kernels`` and
    ``result`` (what ``fn`` returned)."""
    if mesh is not None:
        mesh.reset_stats()
    counter = CostCounter()
    for t in {id(t): t for t in _tensors((args, kwargs), [])}.values():
        if t.device.type == "meta":
            counter.track(t)
    argument_bytes = counter.current
    ops.COST_SINKS.append(counter.kernel)
    try:
        with counter:
            result = fn(*args, **kwargs)
    finally:
        ops.COST_SINKS.remove(counter.kernel)
    by_kind, counts = {}, {}
    log = mesh.collective_log if mesh is not None else {}
    for kind, axes in log.items():
        name = KINDS[kind]
        result_bytes = sum(v["bytes"] for v in axes.values())
        by_kind[name] = result_bytes * FACTOR.get(name, 1.0)
        counts[name] = sum(v["calls"] for v in axes.values())
        counter.bytes += 2 * result_bytes
    return {
        "flops": counter.flops,
        "bytes": counter.bytes,
        "collective": {
            "per_device_bytes": sum(by_kind.values()),
            "by_kind": by_kind,
            "op_counts": counts,
            "by_axis": ({a: dict(v) for a, v in mesh.stats.items()}
                        if mesh is not None else {}),
        },
        "peak_bytes": counter.peak,
        "argument_bytes": argument_bytes,
        "kernels": counter.kernels,
        "result": result,
    }
