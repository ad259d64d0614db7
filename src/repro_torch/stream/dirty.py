"""Per-slot visited-row-block bitsets: delta → minimal dirty slot set
(PyTorch port of ``repro.stream.dirty``).

Soundness is a lockstep argument over the traversal loop.  A slot's
visited mask covers every frontier it ever had (``visited |= frontier``
precedes each expansion), and one expansion level only *reads*

* edges whose SOURCE row holds an active frontier color — rows inside
  visited row-blocks (the sparse engine gathers exactly the active
  row-blocks' edge blocks; the dense sweep reads everything but every
  other edge contributes zero and, for the work counters, counts zero);
* ``visited[dst]`` words — traversal state, not graph data.

So if a delta's touched source rows (`delta.AppliedDelta.touched_rows`,
which conservatively includes every row whose slot population, weights,
work-counter visibility, or LT selection CDF changed) intersect none of
the row-blocks a slot visited, replaying that slot's RNG stream on the
new graph reads only bit-identical inputs at every level — masks AND
counters reproduce exactly, by induction on levels.  Such slots are
*clean*; the rest are *dirty* and must be resampled.

The tracker stores one ``np.packbits`` row-block bitset per slot
(``ceil(NRB / 8)`` bytes — a 1M-vertex graph at 128-row tiles is ~1 KB
per slot) and re-derives bits lazily from the store's own batch list:
``sync()`` compares per-slot ``(batch_index, batch_epoch, graph_epoch)``
signatures and re-records only changed slots, so ordinary refresh /
shrink / grow traffic between deltas costs one reduction per changed
slot, not a rebuild.  The reduction runs where the mask lives (row any →
block any → packed bits, on the card for a CUDA mask), and only the
``ceil(NRB / 8)`` packed bytes come to the host; they equal the
reference's ``np.packbits`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

# np.packbits' bit order: the first of 8 flags is the byte's high bit.
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)

__all__ = ["DirtySlotTracker"]


class DirtySlotTracker:
    """Slot × row-block visited bitsets for one sketch store (or one
    replica group — replicas are bit-identical, so one tracker serves
    all of them)."""

    def __init__(self, num_vertices: int, tile_rows: int):
        self.num_vertices = int(num_vertices)
        self.tile_rows = int(tile_rows)
        self.num_row_blocks = -(-self.num_vertices // self.tile_rows)
        self._nbytes = -(-self.num_row_blocks // 8)
        self._bits = np.zeros((0, self._nbytes), np.uint8)
        # (batch_index, batch_epoch, graph_epoch) per recorded slot.
        self._sig: list[tuple[int, int, int]] = []
        self.deltas_seen = 0
        self.last_dirty_fraction = 0.0

    @classmethod
    def for_store(cls, store) -> "DirtySlotTracker":
        """Tracker sized for ``store`` (row-blocks = the store spec's
        ``tile_size``, the same 128-row tiles `FrontierIndex` groups by),
        synced to its current batches."""
        t = cls(store.graph.num_vertices, store.spec.tile_size)
        t.sync(store)
        return t

    # ----------------------------------------------------------- recording
    def _record_bits(self, visited: torch.Tensor) -> np.ndarray:
        """Packed row-block bitset of one (V, W) visited mask, reduced on
        the mask's device."""
        pad_rows = torch.nn.functional.pad
        row_any = (visited != 0).any(dim=1).to(torch.uint8)      # (V,)
        row_any = pad_rows(row_any, (0, (-row_any.shape[0]) % self.tile_rows))
        blocks = row_any.view(-1, self.tile_rows).amax(dim=1)    # (NRB,)
        blocks = pad_rows(blocks, (0, (-blocks.shape[0]) % 8))
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                               device=blocks.device)
        packed = (blocks.view(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)
        return packed.cpu().numpy()

    def sync(self, store) -> int:
        """Bring the tracker up to date with ``store``'s batch list;
        returns how many slots were (re)recorded.

        Cheap in the steady state: a slot re-records only when its
        signature changed — refresh/ensure swap batch indices, a graph
        epoch bump (delta applied) invalidates every slot's bits.
        """
        n = len(store.batches)
        graph_epoch = getattr(store, "graph_epoch", 0)
        if n > len(self._bits):
            self._bits = np.concatenate(
                [self._bits, np.zeros((n - len(self._bits), self._nbytes),
                                      np.uint8)])
        elif n < len(self._bits):
            self._bits = self._bits[:n].copy()
            del self._sig[n:]
        recorded = 0
        for i in range(n):
            sig = (store.batches[i].batch_index, store.batch_epochs[i],
                   graph_epoch)
            if i < len(self._sig) and self._sig[i] == sig:
                continue
            self._bits[i] = self._record_bits(store.batches[i].visited)
            if i < len(self._sig):
                self._sig[i] = sig
            else:
                self._sig.append(sig)
            recorded += 1
        return recorded

    # ------------------------------------------------------------- queries
    @property
    def num_slots(self) -> int:
        return len(self._bits)

    def dirty_slots(self, row_blocks) -> list[int]:
        """Slots whose visited row-blocks intersect ``row_blocks``."""
        rb = np.asarray(row_blocks, np.int64)
        if len(rb) and (rb.min() < 0 or rb.max() >= self.num_row_blocks):
            raise ValueError(f"row block outside [0, {self.num_row_blocks})")
        query_bits = np.zeros(self.num_row_blocks, bool)
        query_bits[rb] = True
        query = np.packbits(query_bits)
        hit = (self._bits & query).any(axis=1)
        return np.nonzero(hit)[0].tolist()

    def visited_blocks(self, slot: int) -> np.ndarray:
        """Sorted row-block ids slot ``slot``'s traversal visited."""
        bits = np.unpackbits(self._bits[slot])[:self.num_row_blocks]
        return np.nonzero(bits)[0]

    def note_delta(self, dirty: int) -> None:
        """Record one applied delta's dirty fraction for `stats`."""
        self.deltas_seen += 1
        self.last_dirty_fraction = dirty / max(self.num_slots, 1)

    def stats(self) -> dict:
        """Observability payload for `ServingTier.snapshot()`."""
        per_slot = (np.unpackbits(self._bits, axis=1)
                    [:, :self.num_row_blocks].sum(axis=1)
                    if len(self._bits) else np.zeros(0))
        return {
            "slots": self.num_slots,
            "row_blocks": self.num_row_blocks,
            "tracker_bytes": int(self._bits.nbytes),
            "mean_visited_blocks": float(per_slot.mean())
            if len(per_slot) else 0.0,
            "deltas_seen": self.deltas_seen,
            "last_dirty_fraction": self.last_dirty_fraction,
        }
