"""Tombstone compaction: the periodic CSR rebuild that bounds the cost of
the id-stable delta policy (PyTorch port of ``repro.stream.compact``).

`stream.apply_delta` keeps deleted edges in place as prob-0 tombstones so
CSR edge ids (the per-edge RNG counters) stay stable — every delta is
churn-priced, but interior tombstones accumulate: they pad every gather,
ride every frontier-index block, and inflate the padded edge count.
Compaction trades ONE expensive rebuild for a clean graph: drop every
tombstone, rebuild the CSR pair, and resample EVERY pool slot (edge ids
renumber, so per-edge RNG streams move — all previous bits are suspect;
slot ``i`` remains the pure function ``(graph, master_seed,
batch_index_i)``, so the compacted pool is bit-identical to a cold build
on the compacted graph).

Policy lives in the serving tier: `ServingTier.maybe_compact` fires when
`tombstone_fraction` exceeds a threshold (default 10%), swept over every
replica from one shared rebuilt pair so the group re-converges
bit-identically.
"""
from __future__ import annotations

import torch

from repro_torch.graph import csr

__all__ = ["tombstone_fraction", "compact_graph", "compact_store"]


def tombstone_fraction(g: csr.Graph) -> float:
    """Fraction of the forward graph's real edge slots holding prob-0
    tombstones (CSR padding beyond ``num_edges`` doesn't count)."""
    e = g.num_edges
    if not e:
        return 0.0
    return float(torch.count_nonzero(g.prob[:e] == 0.0)) / e


def compact_graph(g: csr.Graph) -> tuple[csr.Graph, csr.Graph]:
    """``(g2, g_rev2)``: the live edges of ``g`` rebuilt as a fresh CSR
    pair — tombstones dropped, edge ids renumbered.

    The live set is duplicate-free by the delta policy (a (src, dst) pair
    exists at most once, live or tombstoned), so no union-merge is needed
    and probabilities carry over bit-for-bit.  The reversed graph is a
    fresh `csr.transpose` — valid here precisely because compaction
    abandons id stability anyway.
    """
    src, dst, prob = g.edges_numpy()
    live = prob > 0
    g2 = csr.from_edges(src[live], dst[live], prob[live], g.num_vertices,
                        device=g.device)
    return g2, csr.transpose(g2)


def compact_store(store) -> float:
    """Compact ``store``'s graph pair in place and resample EVERY slot.

    Returns the tombstone fraction that was reclaimed.  The sampler
    rebind sees a structural change and rebuilds its indexes; resampling
    all slots at their recorded batch indices re-derives the pool on the
    renumbered edge ids — bit-identical to a cold build of the same
    indices on the compacted graph.
    """
    frac = tombstone_fraction(store.graph)
    g2, g_rev2 = compact_graph(store.graph)
    store.apply_graph_update(g2, g_rev2)
    store.resample_slots(list(range(len(store.batches))))
    return frac
