"""Typed edge-delta batches and id-stable CSR delta application (PyTorch
port of ``repro.stream.delta``: the reference's host numpy, with the
mutated graph's tensors placed on the input graph's device at the end).

The whole streaming design hangs on one invariant: **CSR edge ids are
array positions, and the counter RNG is keyed by them** (`core.rng`
draws per ``(seed, level, eid, word)``; LT selections per destination).
A slot resampled at its recorded ``batch_index`` reproduces its old mask
bit-for-bit *iff* every edge it can touch kept its id and its bits.  So
`apply_delta` never rebuilds the edge list (``csr.from_edges`` re-sorts
and renumbers):

* **inserts** resurrect a matching tombstone in place, else extend the
  arrays by exactly the fresh-insert count — consuming k padding slots
  while appending k new ones, so the src-0 padding *population* (which
  the dense work counters see whenever row 0 is active) never changes;
* **deletes** become tombstones — ``prob = 0`` with ``(src, dst)`` kept,
  so the slot stays in its source row-block and every untouched
  traversal's work counters are untouched too; trailing tombstones are
  trimmed back into ``(0, 0, 0)`` padding with the tail sliced off by
  the same count (again population-neutral), which makes insert→delete
  round-trips restore the original arrays bit for bit, length included.

Deltas that carry fresh inserts or trims change ``num_edges`` and the
edge-array layout, so the tile layouts are rebuilt for the new graph;
delete-/resurrect-only deltas keep every shape.
Tombstones accumulate in the interior (only trailing ones trim); the
escape hatch is a periodic full rebuild (``csr.dedupe`` + cold
``ensure``), which renumbers ids and costs a cold build by design.

After a delta the edge arrays are generally NOT src-sorted; ``indptr``
is maintained as the cumulative LIVE out-degree (prob > 0) so
``Graph.degrees`` stays meaningful.  Every traversal consumer is
order-free: the dense sweep and `core.sparse.FrontierIndex` key on the
per-edge ``src`` array (the index argsorts internally), the tile
layouts sort edges themselves, and `lt.selection_cum_before` groups by
``dst``.  ``csr.transpose``/``dedupe``/``relabel`` DO renumber ids —
never apply them to a streamed graph; maintain the reversed graph by
applying ``delta.reversed()`` to it directly.

Preconditions (checked where cheap): the graph is dedupe-clean with
strictly positive live weights — ``prob == 0`` inside ``[:num_edges]``
means *tombstone* to this layer.

Returned alongside the mutated graph, `AppliedDelta.touched_rows` is
the conservative set of source rows whose out-edge slots changed in any
way a traversal or its work counters can observe — the sources of every
structural op and trimmed tombstone, and, under ``lt_normalized=True``,
of every live in-edge of a re-normalized destination.  The
population-neutral insert/trim policy above is what keeps row 0 OFF
this list: padding slots carry ``src == 0``, so a padding-count change
would dirty every traversal that ever activates row 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lt
from repro_torch.graph import csr

__all__ = ["EdgeDelta", "AppliedDelta", "apply_delta", "random_delta",
           "touched_row_blocks"]


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """One batch of edge mutations: inserts (with weights) and deletes.

    ``weight[i]`` must be a finite positive float where ``insert[i]``
    (streaming keeps the live-weight-positive invariant — a zero weight
    is a tombstone, not an edge); it is ignored for deletes.  A single
    delta must not name the same ``(src, dst)`` pair twice — the apply
    order within one batch would be ambiguous; split into two deltas.
    """
    src: np.ndarray      # (K,) int32
    dst: np.ndarray      # (K,) int32
    weight: np.ndarray   # (K,) float32; > 0 where insert
    insert: np.ndarray   # (K,) bool; False = delete

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))
        object.__setattr__(self, "weight",
                           np.asarray(self.weight, np.float32))
        object.__setattr__(self, "insert", np.asarray(self.insert, bool))
        k = len(self.src)
        if not (len(self.dst) == len(self.weight) == len(self.insert) == k):
            raise ValueError("EdgeDelta arrays must share one length")
        w = self.weight[self.insert]
        if len(w) and (not np.all(np.isfinite(w)) or np.any(w <= 0)):
            raise ValueError("insert weights must be finite and > 0 "
                             "(prob == 0 slots are tombstones)")
        pairs = self.src.astype(np.int64) << 32 | self.dst.astype(np.uint32)
        if len(np.unique(pairs)) != k:
            raise ValueError("duplicate (src, dst) pair within one delta — "
                             "apply order would be ambiguous; split it")

    # ------------------------------------------------------- constructors
    @classmethod
    def inserts(cls, src, dst, weight) -> "EdgeDelta":
        src = np.asarray(src, np.int32)
        return cls(src, np.asarray(dst, np.int32),
                   np.asarray(weight, np.float32),
                   np.ones(len(src), bool))

    @classmethod
    def deletes(cls, src, dst) -> "EdgeDelta":
        src = np.asarray(src, np.int32)
        return cls(src, np.asarray(dst, np.int32),
                   np.zeros(len(src), np.float32),
                   np.zeros(len(src), bool))

    @classmethod
    def concat(cls, *deltas: "EdgeDelta") -> "EdgeDelta":
        return cls(np.concatenate([d.src for d in deltas]),
                   np.concatenate([d.dst for d in deltas]),
                   np.concatenate([d.weight for d in deltas]),
                   np.concatenate([d.insert for d in deltas]))

    # ------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self.src)

    @property
    def num_inserts(self) -> int:
        return int(self.insert.sum())

    @property
    def num_deletes(self) -> int:
        return len(self) - self.num_inserts

    def reversed(self) -> "EdgeDelta":
        """The same delta on the transposed graph (src/dst swapped) —
        how the stream layer maintains ``g_rev`` without `csr.transpose`
        (which would renumber every edge id)."""
        return EdgeDelta(self.dst, self.src, self.weight, self.insert)

    def inverse(self) -> "EdgeDelta":
        """The delta that undoes this one — defined for all-insert
        deltas only (a delete's inverse needs the deleted weight, which
        lives in the graph, not the delta)."""
        if self.num_deletes:
            raise ValueError("inverse() is only defined for all-insert "
                             "deltas (deleted weights live in the graph)")
        return EdgeDelta.deletes(self.src, self.dst)


@dataclasses.dataclass(frozen=True)
class AppliedDelta:
    """What `apply_delta` did: the observable blast radius + op counts.

    ``touched_rows`` is sorted-unique and conservative: every source row
    whose slot population OR slot bits changed (masks or work counters
    of a traversal entering the row could change).  A traversal that
    never visited any touched row reproduces bit-identically on the new
    graph — the `DirtySlotTracker` soundness contract.
    """
    touched_rows: np.ndarray    # sorted unique int32
    inserted: int
    deleted: int
    resurrected: int            # inserts that re-filled a tombstone
    appended: int               # fresh inserts = array slots appended
    trimmed: int                # trailing tombstones sliced back off


def _pair_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    return src.astype(np.int64) << 32 | dst.astype(np.uint32)


def apply_delta(g: csr.Graph, delta: EdgeDelta, *,
                lt_normalized: bool = False) \
        -> tuple[csr.Graph, AppliedDelta]:
    """Apply ``delta`` to ``g`` with stable CSR edge ids (see module doc).

    ``lt_normalized=True`` declares ``g`` an LT-normalized reversed graph
    (`lt.normalize_lt_weights` invariant: per-dst in-weights sum ≤ 1):
    after the structural ops, the live in-edges of every destination the
    delta touched are re-normalized in place with the exact
    `normalize_lt_weights` arithmetic (float64 per-dst sums in array
    order, ``scale = 1/max(1, Σ)``, float32 cast), confined to those
    destinations — untouched rows keep their bytes.  Normalization is a
    lossy projection (weights only ever scale DOWN): deleting an insert
    that pushed a sum past 1 does not restore the pre-insert bits unless
    the sums stayed ≤ 1 throughout.

    Functional: ``g`` is never mutated; arrays are copied once (O(E)
    host numpy — vectorized, and cheap next to any slot resample).  The
    result is a new graph object with an empty ``cache``: nothing derived
    from ``g`` (transpose, tile layouts, slot lists) carries over.
    """
    v = g.num_vertices
    e = g.num_edges
    src = g.src.cpu().numpy().copy()
    dst = g.dst.cpu().numpy().copy()
    prob = g.prob.cpu().numpy().copy()

    if len(delta) and (delta.src.min() < 0 or delta.dst.min() < 0
                       or delta.src.max() >= v or delta.dst.max() >= v):
        raise ValueError(f"delta names vertices outside [0, {v})")

    # ---- match delta pairs against the existing slots (live + tombstone)
    keys = _pair_keys(src[:e], dst[:e])
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    if e and np.any(skeys[1:] == skeys[:-1]):
        raise ValueError("graph has parallel (src, dst) slots — streaming "
                         "needs a dedupe-clean graph (csr.dedupe)")
    dkeys = _pair_keys(delta.src, delta.dst)
    where = np.searchsorted(skeys, dkeys)
    cand = order[np.minimum(where, max(e - 1, 0))] if e else \
        np.zeros(len(delta), np.int64)
    found = (where < e) & (e > 0)
    found &= np.where(found, keys[cand] == dkeys, False)

    touched: list[np.ndarray] = []
    # Row-0 work-counter invariant: the dense sweep counts EVERY padded
    # slot whose source row is active, and padding slots carry src 0 — so
    # the row-0 *slot count* must never change, or every traversal that
    # activates row 0 would need a resample just to fix its counters.
    # Fresh inserts therefore EXTEND the arrays by exactly their count
    # (consuming k padding slots while appending k new ones: net zero)
    # and the trailing-tombstone trim SLICES the same number of padding
    # slots off the tail (tombstone → padding conversion: net zero).
    pad_count = len(src) - e

    # ------------------------------------------------------------ deletes
    del_mask = ~delta.insert
    bad = del_mask & (~found | (prob[np.where(found, cand, 0)] <= 0))
    if np.any(bad):
        i = int(np.nonzero(bad)[0][0])
        raise KeyError(f"delete of absent edge "
                       f"({int(delta.src[i])}, {int(delta.dst[i])})")
    del_pos = cand[del_mask]
    prob[del_pos] = 0.0
    touched.append(delta.src[del_mask])

    # ------------------------------------------------------------ inserts
    ins_mask = delta.insert
    dup = ins_mask & found & (prob[np.where(found, cand, 0)] > 0)
    if np.any(dup):
        i = int(np.nonzero(dup)[0][0])
        raise KeyError(f"insert of live edge "
                       f"({int(delta.src[i])}, {int(delta.dst[i])}) — "
                       "delete it first or use a different pair")
    res_mask = ins_mask & found            # tombstone resurrection, in place
    prob[cand[res_mask]] = delta.weight[res_mask]
    resurrected = int(res_mask.sum())

    fresh = ins_mask & ~found
    n_fresh = int(fresh.sum())
    if n_fresh:
        z32 = np.zeros(n_fresh, np.int32)
        src = np.concatenate([src, z32])
        dst = np.concatenate([dst, z32])
        prob = np.concatenate([prob, np.zeros(n_fresh, np.float32)])
        pos = np.arange(e, e + n_fresh)
        src[pos] = delta.src[fresh]
        dst[pos] = delta.dst[fresh]
        prob[pos] = delta.weight[fresh]
        e += n_fresh            # pad slots consumed == appended: net zero
    touched.append(delta.src[ins_mask])

    # ---- trim trailing tombstones back into padding (slot → (0,0,0)),
    # slicing the same number of slots off the tail so the padding count
    # — hence the row-0 population — is unchanged.  Makes insert→delete
    # round-trips restore the ORIGINAL arrays bit for bit, length included.
    trimmed = 0
    while e > 0 and prob[e - 1] == 0.0:
        touched.append(src[e - 1: e].copy())    # slot leaves its row group
        src[e - 1] = dst[e - 1] = 0
        e -= 1
        trimmed += 1
    if trimmed:
        src = src[:e + pad_count]
        dst = dst[:e + pad_count]
        prob = prob[:e + pad_count]

    # --------------------------------------- confined LT re-normalization
    if lt_normalized and len(delta):
        affected = np.unique(delta.dst)
        sel = np.isin(dst[:e], affected)
        # Exact normalize_lt_weights arithmetic on the affected dsts:
        # float64 per-dst sums accumulated in array order (tombstones add
        # an exact +0.0), scale = 1/max(1, Σ), float32 cast.
        p64 = prob[:e].astype(np.float64)
        in_sum = np.zeros(v)
        np.add.at(in_sum, dst[:e][sel], p64[sel])
        scale = 1.0 / np.maximum(in_sum[dst[:e][sel]], 1.0)
        prob[:e][sel] = (p64[sel] * scale).astype(np.float32)
        # Conservative: every live in-edge of an affected dst may have
        # been rescaled — its source row is touched.
        touched.append(src[:e][sel & (prob[:e] > 0)])

    # ------------------------------------------------- live-degree indptr
    live_src = src[:e][prob[:e] > 0]
    counts = np.bincount(live_src, minlength=v)
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])

    dev = g.device
    g2 = csr.Graph(indptr=torch.from_numpy(indptr.astype(np.int32)).to(dev),
                   src=torch.from_numpy(src).to(dev),
                   dst=torch.from_numpy(dst).to(dev),
                   prob=torch.from_numpy(prob).to(dev),
                   num_vertices=v, num_edges=int(e))
    if lt_normalized:
        # The invariant holds again; the sampler uses these weights as
        # they are (`lt.normalized`), so untouched rows keep their bits.
        lt.declare_normalized(g2)
    rows = (np.unique(np.concatenate(touched).astype(np.int32))
            if touched else np.zeros(0, np.int32))
    return g2, AppliedDelta(touched_rows=rows,
                            inserted=int(ins_mask.sum()),
                            deleted=int(del_mask.sum()),
                            resurrected=resurrected,
                            appended=n_fresh, trimmed=trimmed)


def touched_row_blocks(touched_rows: np.ndarray, tile_rows: int) -> np.ndarray:
    """Sorted-unique `FrontierIndex` row-block ids covering the rows."""
    return np.unique(np.asarray(touched_rows, np.int64) // int(tile_rows))


def random_delta(g: csr.Graph, rng: np.random.Generator, *,
                 num_deletes: int, num_inserts: int,
                 dst_rows: np.ndarray | None = None,
                 weight_range: tuple[float, float] = (0.01, 0.1)) -> EdgeDelta:
    """A well-formed random delta for smokes/benchmarks: deletes sampled
    from the live edges, inserts from currently-absent pairs.

    ``dst_rows`` confines both ops to edges whose DESTINATION lies in the
    given rows — on the reversed graph those destinations are the source
    rows, so a benchmark can dial the touched-row-block fraction (churn)
    directly.
    """
    src, dst, prob = g.edges_numpy()
    live = np.nonzero(prob > 0)[0]
    if dst_rows is not None:
        allowed = np.zeros(g.num_vertices, bool)
        allowed[np.asarray(dst_rows, np.int64)] = True
        live = live[allowed[dst[live]]]
    num_deletes = min(num_deletes, len(live))
    del_pos = rng.choice(live, size=num_deletes, replace=False) \
        if num_deletes else np.zeros(0, np.int64)

    taken = set(_pair_keys(src, dst).tolist())
    pairs: list[tuple[int, int]] = []
    dst_pool = (np.asarray(dst_rows, np.int64) if dst_rows is not None
                else np.arange(g.num_vertices))
    for _ in range(20 * num_inserts + 20):
        if len(pairs) >= num_inserts:
            break
        s = int(rng.integers(0, g.num_vertices))
        d = int(dst_pool[rng.integers(0, len(dst_pool))])
        k = (s << 32) | d
        if s != d and k not in taken:
            taken.add(k)
            pairs.append((s, d))
    ins_src = np.asarray([p[0] for p in pairs], np.int32)
    ins_dst = np.asarray([p[1] for p in pairs], np.int32)
    lo, hi = weight_range
    return EdgeDelta.concat(
        EdgeDelta.deletes(src[del_pos], dst[del_pos]),
        EdgeDelta.inserts(ins_src, ins_dst,
                          rng.uniform(lo, hi, len(pairs))))
