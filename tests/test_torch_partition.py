"""Port ≡ reference for the graph-parallel row partition
(`repro_torch.graph.partition`).

On a graph whose destinations avoid several 32-row blocks (so shards hold
empty destination blocks, and at S = 4 one shard holds no tile), for
S ∈ {1, 2, 3, 4}: `shard_rows` and each rank's `ShardLayout` give the
reference's row split and tile assignment (the reference's stacked
``partition``, read tile by tile); and each shard's slot list, built by a
rank from the CSR edges (`ShardLayout.slot_list`, for IC and for LT),
equals the list read from the reference's stack of that shard — global
source rows, local destination rows.
Tolerance: exact (integer and float32 words copied)."""
import numpy as np
import pytest
import torch

from repro.core import lt as jlt
from repro.core import tiles as jtiles
from repro.graph import csr as jcsr
from repro.graph import partition as jpart
from repro_torch import convert
from repro_torch.core import lt, tiles
from repro_torch.graph import partition

torch.set_num_threads(1)

T = 32
# Destinations only in blocks 0, 1, 4 and 8 of 10: blocks 2, 3, 5-7 and 9
# receive no edge.
DST_BLOCKS = (0, 1, 4, 8)


@pytest.fixture(scope="module")
def graphs():
    n, e = 300, 2400
    rs = np.random.default_rng(5)
    src = rs.integers(0, n, e)
    dst = (rs.choice(DST_BLOCKS, e) * T + rs.integers(0, T, e)) % n
    keep = src != dst
    prob = rs.uniform(0.05, 0.9, keep.sum()).astype(np.float32)
    gj = jcsr.from_edges(src[keep], dst[keep], prob, n, dedupe=True)
    gt = convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), n, gj.num_edges, device="cpu")
    return gj, gt


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_rows_equal_the_reference(graphs, shards):
    gj, gt = graphs
    pj = jpart.partition(jtiles.from_graph(gj, T), shards)
    assert partition.blocks_per_shard(gt.num_vertices, T, shards) == \
        pj.blocks_per_shard
    for s in range(shards):
        assert partition.shard_rows(gt.num_vertices, T, shards, s) == \
            (s * pj.rows_per_shard, pj.rows_per_shard)
        layout = partition.shard_layout(gt, T, shards, s)
        assert (layout.rows, layout.row_base, layout.padded_vertices) == \
            (pj.rows_per_shard, s * pj.rows_per_shard, pj.padded_vertices)
    if shards == 4:                      # the last shard holds no tile
        assert not np.asarray(pj.prob)[3].any()
        assert partition.shard_layout(gt, T, shards, 3).num_tiles == 0


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_tiles_follow_the_reference_assignment(graphs, shards):
    """Each shard holds the reference shard's tiles in its order (global
    source block, local destination block), and every edge lies in
    exactly one shard."""
    gj, gt = graphs
    pj = jpart.partition(jtiles.from_graph(gj, T), shards)
    seen = []
    for s in range(shards):
        layout = partition.shard_layout(gt, T, shards, s)
        nt = layout.num_tiles
        first = np.searchsorted(layout.tile, np.arange(nt))
        np.testing.assert_array_equal(layout.src_row[first] // T,
                                      np.asarray(pj.tile_src)[s, :nt])
        np.testing.assert_array_equal(layout.dst_row[first] // T,
                                      np.asarray(pj.tile_dst)[s, :nt])
        assert not np.asarray(pj.prob)[s, nt:].any()   # padding tiles
        seen.append(layout.eids)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(gt.num_edges))


def _stack_list(prob, keys, tile_src, tile_dst):
    """The slot list of one shard's reference stacks (tile by tile; within
    a tile by destination lane, then source row)."""
    t, i, j = np.nonzero(prob > 0)
    order = np.lexsort((i, j, t))
    t, i, j = t[order], i[order], j[order]
    return (np.bincount(t, minlength=prob.shape[0]),
            tile_src[t] * T + i, tile_dst[t] * T + j, prob[t, i, j],
            keys[t, i, j])


@pytest.mark.parametrize("diffusion", ["ic", "lt"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_slot_lists_equal_the_reference_stacks(graphs, shards,
                                                     diffusion):
    gj, gt = graphs
    if diffusion == "lt":
        gj = jlt.normalize_lt_weights(gj)
        gt = lt.normalized(gt)
    tj = jtiles.from_graph(gj, T)
    pj = jpart.partition(tj, shards)
    if diffusion == "lt":
        cb = np.asarray(jlt.selection_cum_before(gj), np.float32)
        stack_keys = jpart.partition_tile_values(
            tj, shards, jtiles.edge_values_to_tiles(tj, cb)).view(np.int32)
        keys = np.asarray(lt.selection_cum_before(gt), np.float32) \
            .view(np.int32)
    else:
        stack_keys = np.asarray(pj.edge_id).view(np.int32)
        keys = np.arange(gt.num_edges, dtype=np.int32)
    prob = gt.edges_numpy()[2]
    for s in range(shards):
        layout = partition.shard_layout(gt, T, shards, s)
        got = layout.slot_list(prob, keys, "cpu")
        counts, src_row, dst_row, value, key = _stack_list(
            np.asarray(pj.prob)[s], stack_keys[s], np.asarray(pj.tile_src)[s],
            np.asarray(pj.tile_dst)[s])
        assert layout.num_tiles <= len(counts)
        assert not counts[layout.num_tiles:].any()     # padding tiles
        np.testing.assert_array_equal(np.diff(got.slot_ptr.numpy()),
                                      counts[:layout.num_tiles])
        for name, want in (("src_row", src_row), ("dst_row", dst_row),
                           ("value", value), ("key", key)):
            np.testing.assert_array_equal(getattr(got, name).numpy(), want,
                                          err_msg=f"shard {s} {name}")
        assert (got.src_rows, got.dst_rows) == (pj.padded_vertices,
                                                pj.rows_per_shard)
        assert layout.row_base == s * pj.rows_per_shard
