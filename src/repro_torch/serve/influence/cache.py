"""Epoch-keyed LRU result cache for influence queries (port of
``repro.serve.influence.cache``; plain Python, unchanged in behaviour).

Entries are tagged with the sketch pool ``version`` they were computed
against; a lookup under any other version is a miss and evicts the stale
entry, so a pool refresh invalidates the whole working set without a scan.
Keys are canonical seed-set tuples.  ``get``/``put``/``clear`` hold an
internal lock and ``stats()`` returns one atomic snapshot of the counters.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable


def seed_key(seeds) -> tuple:
    """Canonical cache key for a seed set (order/duplicate insensitive)."""
    return tuple(sorted({int(s) for s in seeds}))


class ResultCache:
    """LRU over (kind, key) entries, each pinned to a pool version."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._entries: OrderedDict[tuple, tuple[Hashable, Any]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, version: Hashable, kind: str, key: Hashable):
        """Value if present AND computed under ``version``; else None."""
        with self._lock:
            entry = self._entries.get((kind, key))
            if entry is None:
                self.misses += 1
                return None
            ver, value = entry
            if ver != version:
                del self._entries[(kind, key)]          # stale epoch
                self.misses += 1
                return None
            self._entries.move_to_end((kind, key))
            self.hits += 1
            return value

    def put(self, version: Hashable, kind: str, key: Hashable, value) -> None:
        with self._lock:
            self._entries[(kind, key)] = (version, value)
            self._entries.move_to_end((kind, key))
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def stats(self) -> dict:
        """Atomic counter snapshot: {hits, misses, size, hit_rate}."""
        with self._lock:
            hits, misses, size = self.hits, self.misses, len(self._entries)
        total = hits + misses
        return {"hits": hits, "misses": misses, "size": size,
                "hit_rate": (hits / total) if total else 0.0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
