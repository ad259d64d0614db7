"""Port ≡ reference for the slot lists of the two IC tile kernels.

``fused_expand`` and ``fused_expand_q`` walk a per-tile list of the nonzero
slots of their stack (`repro_torch.core.tiles.ic_slot_list`,
`q_slot_list`).  On CPU tensors `repro_torch.kernels.ops` runs the plain
versions over that list (`kernels.ref.fused_expand_slots_ref`,
`fused_expand_q_slots_ref`); here each is held, bit for bit, against the
tile-form plain version that defines the result
(`kernels.ref.fused_expand_ref`, `fused_expand_q_ref`) and against the
reference's Pallas kernels in interpret mode, on the dense grid and on
compacted tile lists, at 1, 2, 4 and 8 words.  The CUDA kernels are held
against the same plain versions on the GPU (`tests/test_torch_cuda.py`,
``chip_smoke.py``).  Tolerance: exact everywhere (integer words)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiles as jtiles
from repro.graph import csr as jcsr
from repro.kernels import fused_expand as jfe
from repro.kernels import fused_expand_q as jfeq
from repro_torch import convert
from repro_torch.core import tiles
from repro_torch.kernels import ops, ref

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

SEED, LEVEL = 0xDEADBEEF, 5


def _pair(n, e, p, *, seed, tile_size=32, dst_limit=None, pad=0):
    """(reference tiles, port tiles) of one dedupe-clean random graph;
    destinations below ``dst_limit`` (blocks above it get no tile), ``pad``
    padding tiles, probabilities uniform on ``p`` (a range)."""
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n, e)
    dst = rs.integers(0, dst_limit or n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    prob = rs.uniform(*p, len(src)).astype(np.float32)
    gj = jcsr.from_edges(src, dst, prob, n, dedupe=True)
    gt = convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), n, gj.num_edges, device="cpu")
    pad_to = jtiles.from_graph(gj, tile_size).num_tiles + pad if pad else None
    return (jtiles.from_graph(gj, tile_size, pad_tiles_to=pad_to),
            tiles.from_graph(gt, tile_size, pad_tiles_to=pad_to), gt)


def _masks(vp, colors, seed, density):
    """(frontier, visited ⊇ frontier) uint32 masks with random bits."""
    rs = np.random.default_rng(seed)
    w = -(-colors // 32)

    def bits(p):
        lanes = rs.random((vp, w, 32)) < p
        return (np.packbits(lanes, axis=-1, bitorder="little")
                .view(np.uint32)[..., 0])

    fr = bits(density)
    return fr, fr | bits(0.2)


def _t(words):
    return convert.masks_from_numpy(words, "cpu")


def _lists(tt):
    """(name, ascending int32 tile ids) of the compacted-list cases: empty,
    the tiles of one source block, every tile."""
    act = torch.zeros(tt.num_blocks, dtype=torch.bool)
    out = [("empty", tiles.active_tile_ids(tt.tile_src, act))]
    act[int(tt.tile_src[0])] = True
    out.append(("one source block", tiles.active_tile_ids(tt.tile_src, act)))
    act[:] = True
    out.append(("full", tiles.active_tile_ids(tt.tile_src, act)))
    return out


def _first_of(tile_dst):
    """The reference's run-start flags of a gathered dst-sorted list."""
    return jnp.concatenate([jnp.ones((1,), jnp.int32),
                            (tile_dst[1:] != tile_dst[:-1]).astype(jnp.int32)])


# ------------------------------------------------------------------- IC
@pytest.mark.parametrize("colors", [32, 64, 128, 256])
def test_ic_dense_grid_list_equals_tiles_and_pallas(colors):
    """Every tile, 1-8 words, with padding tiles and destination blocks no
    tile reaches."""
    tj, tt, _ = _pair(300, 1500, (0.05, 0.9), seed=colors, dst_limit=200,
                      pad=4)
    assert tt.num_blocks > int(tt.tile_dst.max()) + 1
    fr, vis = _masks(tt.padded_vertices, colors, colors, 0.2)
    pallas = np.asarray(jfe.fused_expand(
        tj.prob, tj.edge_id, tj.tile_src, tj.tile_dst, tj.first_of_dst,
        jnp.asarray(fr), jnp.asarray(vis), jnp.uint32(SEED),
        jnp.uint32(LEVEL), interpret=True))
    tile_form = ref.fused_expand_ref(tt.prob, tt.edge_id, tt.tile_src,
                                     tt.tile_dst, _t(fr), _t(vis), SEED,
                                     LEVEL)
    got = ops.fused_expand(tt, _t(fr), _t(vis), SEED, LEVEL)
    assert pallas.any()
    np.testing.assert_array_equal(convert.masks_to_numpy(tile_form), pallas)
    np.testing.assert_array_equal(convert.masks_to_numpy(got), pallas)


@pytest.mark.parametrize("colors", [32, 64, 128, 256])
def test_ic_compacted_lists_equal_gathered_tiles_and_pallas(colors):
    """The listed tiles' entries ≡ the tile-form plain version and the
    Pallas kernel on the gathered tiles (any frontier: tiles off the list
    take no part), for the empty, one-source-block and full lists."""
    tj, tt, _ = _pair(300, 1500, (0.05, 0.9), seed=colors + 1,
                      dst_limit=200, pad=4)
    fr, vis = _masks(tt.padded_vertices, colors, colors, 0.3)
    for name, ids in _lists(tt):
        sel = ids.long()
        got = ops.fused_expand(tt, _t(fr), _t(vis), SEED, LEVEL,
                               tile_ids=ids)
        tile_form = ref.fused_expand_ref(
            tt.prob[sel], tt.edge_id[sel], tt.tile_src[sel],
            tt.tile_dst[sel], _t(fr), _t(vis), SEED, LEVEL)
        np.testing.assert_array_equal(convert.masks_to_numpy(got),
                                      convert.masks_to_numpy(tile_form),
                                      err_msg=name)
        if ids.numel() == 0:
            assert not bool(got.any())
            continue
        jid = jnp.asarray(ids.numpy())
        pallas = np.asarray(jfe.fused_expand(
            tj.prob[jid], tj.edge_id[jid], tj.tile_src[jid],
            tj.tile_dst[jid], _first_of(tj.tile_dst[jid]), jnp.asarray(fr),
            jnp.asarray(vis), jnp.uint32(SEED), jnp.uint32(LEVEL),
            interpret=True))
        assert pallas.any(), name
        np.testing.assert_array_equal(convert.masks_to_numpy(got), pallas,
                                      err_msg=name)


def test_ic_list_holds_the_positive_slots_sorted_by_destination_lane():
    _, tt, gt = _pair(300, 1500, (0.0, 0.9), seed=3, pad=2)
    slots = tiles.ic_slot_list(tt)
    T = tt.tile_size
    assert slots.num_entries == int((tt.prob > 0).sum())
    assert slots.num_entries <= gt.num_edges
    assert slots.num_tiles == tt.num_tiles
    assert slots.src_rows <= tt.padded_vertices
    assert slots.dst_rows <= tt.padded_vertices
    counts = (tt.prob > 0).sum((1, 2))
    np.testing.assert_array_equal(np.diff(slots.slot_ptr.numpy()),
                                  counts.numpy())
    tile = torch.repeat_interleave(torch.arange(tt.num_tiles), counts)
    i = slots.src_row.long() - tt.tile_src[tile].long() * T
    j = slots.dst_row.long() - tt.tile_dst[tile].long() * T
    assert bool(((i >= 0) & (i < T) & (j >= 0) & (j < T)).all())
    assert bool((torch.diff(tile * T * T + j * T + i) > 0).all())
    assert torch.equal(slots.value, tt.prob[tile, i, j])
    assert torch.equal(slots.key, tt.edge_id[tile, i, j])


# ------------------------------------------------------------- quantised
def _q_pair(seed, *, pad=0, low=False):
    """(reference tiles, reference q8, port tiles, port q8): the port's
    layout is `convert.quantized_tiles_from_numpy` of the reference's
    arrays (padding tiles kept, list built from the stack); ``low`` puts a
    third of the edges at 0 < p < 1.5/256, where q = 0."""
    rs = np.random.default_rng(seed)
    n, e = 300, 1500
    src = rs.integers(0, n, e)
    dst = rs.integers(0, 200, e)
    keep = src != dst
    prob = rs.uniform(0.05, 0.95, keep.sum()).astype(np.float32)
    if low:
        prob[::3] = rs.uniform(1e-4, 1.4 / 256, prob[::3].shape)
    gj = jcsr.from_edges(src[keep], dst[keep], prob, n, dedupe=True)
    pad_to = jtiles.from_graph(gj, 32).num_tiles + pad if pad else None
    tj = jtiles.from_graph(gj, 32, pad_tiles_to=pad_to)
    q8j = jfeq.quantize_probs(tj.prob)
    tg, q8 = convert.quantized_tiles_from_numpy(
        np.asarray(tj.tile_src), np.asarray(tj.tile_dst), np.asarray(q8j),
        n, gj.num_edges, device="cpu")
    return tj, q8j, tg, q8


@pytest.mark.parametrize("colors", [32, 64, 128, 256])
def test_q_dense_grid_list_equals_tiles_and_pallas(colors):
    tj, q8j, tg, q8 = _q_pair(colors, pad=3)
    fr, vis = _masks(tg.padded_vertices, colors, colors, 0.2)
    args = (jnp.asarray(fr), jnp.asarray(vis), jnp.uint32(SEED),
            jnp.uint32(LEVEL))
    pallas = np.asarray(jfeq.fused_expand_q(
        q8j, tj.tile_src, tj.tile_dst, tj.first_of_dst, *args,
        interpret=True))
    tile_form = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst, _t(fr),
                                       _t(vis), SEED, LEVEL)
    got = ops.fused_expand_q(tg, q8, _t(fr), _t(vis), SEED, LEVEL)
    assert pallas.any()
    np.testing.assert_array_equal(convert.masks_to_numpy(tile_form), pallas)
    np.testing.assert_array_equal(convert.masks_to_numpy(got), pallas)


@pytest.mark.parametrize("colors", [32, 64, 128, 256])
def test_q_compacted_lists_equal_gathered_tiles_and_pallas(colors):
    """List mode ≡ the tile form on the same list ≡ the reference's
    ``fused_expand_q_gathered`` (keyed on the original tile ids)."""
    tj, q8j, tg, q8 = _q_pair(colors + 1, pad=3)
    fr, vis = _masks(tg.padded_vertices, colors, colors, 0.3)
    for name, ids in _lists(tg):
        got = ops.fused_expand_q(tg, q8, _t(fr), _t(vis), SEED, LEVEL,
                                 tile_ids=ids)
        tile_form = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst,
                                           _t(fr), _t(vis), SEED, LEVEL,
                                           tile_ids=ids)
        np.testing.assert_array_equal(convert.masks_to_numpy(got),
                                      convert.masks_to_numpy(tile_form),
                                      err_msg=name)
        if ids.numel() == 0:
            assert not bool(got.any())
            continue
        jid = jnp.asarray(ids.numpy())
        pallas = np.asarray(jfeq.fused_expand_q_gathered(
            q8j[jid], jid, tj.tile_src[jid], tj.tile_dst[jid],
            _first_of(tj.tile_dst[jid]), jnp.asarray(fr), jnp.asarray(vis),
            jnp.uint32(SEED), jnp.uint32(LEVEL), interpret=True))
        assert pallas.any(), name
        np.testing.assert_array_equal(convert.masks_to_numpy(got), pallas,
                                      err_msg=name)


def test_q_list_leaves_out_slots_that_quantise_to_zero():
    """0 < p < 1.5/256 gives q = 0, which never crosses: such slots are not
    listed, and the level still equals the Pallas kernel's."""
    tj, q8j, tg, q8 = _q_pair(9, low=True)
    slots = tiles.q_slot_list(tg, q8)
    low = (np.asarray(tj.prob) > 0) & (np.asarray(q8j) == 0)
    assert low.sum() > 100
    assert slots.num_entries == int((q8 > 0).sum()) \
        == int((np.asarray(tj.prob) > 0).sum() - low.sum())
    assert bool((slots.value > 0).all())
    fr, vis = _masks(tg.padded_vertices, 64, 9, 0.5)
    pallas = np.asarray(jfeq.fused_expand_q(
        q8j, tj.tile_src, tj.tile_dst, tj.first_of_dst, jnp.asarray(fr),
        jnp.asarray(vis), jnp.uint32(SEED), jnp.uint32(LEVEL),
        interpret=True))
    got = ops.fused_expand_q(tg, q8, _t(fr), _t(vis), SEED, LEVEL)
    np.testing.assert_array_equal(convert.masks_to_numpy(got), pallas)


def test_q_list_keys_are_the_cells_of_the_original_tile_ids():
    _, _, tg, q8 = _q_pair(4, pad=2)
    slots = tiles.q_slot_list(tg, q8)
    T = tg.tile_size
    counts = (q8 > 0).sum((1, 2))
    tile = torch.repeat_interleave(torch.arange(tg.num_tiles), counts)
    i = slots.src_row.long() - tg.tile_src[tile].long() * T
    j = slots.dst_row.long() - tg.tile_dst[tile].long() * T
    np.testing.assert_array_equal(
        convert.masks_to_numpy(slots.key).astype(np.int64),
        ref.q_cell_ids(tile, i, j, T).numpy())
    assert torch.equal(slots.value, q8[tile, i, j])


# ------------------------------------------------------- how it is built
@pytest.mark.parametrize("chunk_tiles", [1, 3, 1000])
def test_list_from_the_host_arrays_equals_the_list_from_the_stack(
        chunk_tiles, monkeypatch):
    """``from_graph`` and ``quantized`` build the list from their host
    arrays; a stack they did not list (a copy, here) is read in chunks
    of tiles: the two lists are the same, field for field."""
    _, tt, gt = _pair(300, 1500, (0.0, 0.9), seed=11, pad=3)
    tq, q8 = tiles.quantized(gt, 32)
    host_ic, host_q = tiles.ic_slot_list(tt), tiles.q_slot_list(tq, q8)
    monkeypatch.setattr(tiles, "SLOT_CHUNK", chunk_tiles * 32 * 32)
    copy_ic = tiles.ic_slot_list(dataclasses.replace(
        tt, prob=tt.prob.clone(), edge_id=tt.edge_id.clone()))
    copy_q = tiles.q_slot_list(tq, q8.clone())
    for host, copy in ((host_ic, copy_ic), (host_q, copy_q)):
        assert copy is not host
        for field in dataclasses.fields(host):
            a, b = getattr(host, field.name), getattr(copy, field.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), field.name
            else:
                assert a == b, field.name


def test_list_is_built_once_per_stack_and_keyed_by_identity():
    _, tt, gt = _pair(300, 1500, (0.1, 0.9), seed=12)
    first = tiles.ic_slot_list(tt)
    assert tiles.ic_slot_list(tt) is first
    fr, vis = _masks(tt.padded_vertices, 64, 1, 0.3)
    ops.fused_expand(tt, _t(fr), _t(vis), 1, 0)
    assert tiles.ic_slot_list(tt) is first
    # An equal stack that is another tensor gets its own list.
    other = dataclasses.replace(tt, prob=tt.prob.clone())
    assert tiles.ic_slot_list(other) is not first
    tq, q8 = tiles.quantized(gt, 32)
    assert tiles.q_slot_list(tq, q8) is tiles.q_slot_list(tq, q8)
    # LT layouts carry no edge ids and build no list.
    lt = tiles.from_graph(gt, 32, edge_ids=False)
    with pytest.raises(ValueError, match="edge id"):
        tiles.ic_slot_list(lt)


def test_hub_destination_reached_by_many_edges():
    """One destination row with 200 in-edges (more than a warp's 32 lanes
    on the card): both lists equal their tile forms."""
    n = 256
    src = np.arange(1, 201)
    dst = np.zeros(200, np.int64)
    rs = np.random.default_rng(5)
    extra_s, extra_d = rs.integers(0, n, 400), rs.integers(0, n, 400)
    keep = extra_s != extra_d
    src = np.concatenate([src, extra_s[keep]])
    dst = np.concatenate([dst, extra_d[keep]])
    prob = rs.uniform(0.1, 0.9, len(src)).astype(np.float32)
    gj = jcsr.from_edges(src, dst, prob, n, dedupe=True)
    gt = convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), n, gj.num_edges, device="cpu")
    tt = tiles.from_graph(gt, 64)
    assert int((tiles.ic_slot_list(tt).dst_row == 0).sum()) >= 200
    fr, vis = _masks(tt.padded_vertices, 64, 6, 0.5)
    vis[0] = 0
    got = ops.fused_expand(tt, _t(fr), _t(vis), SEED, LEVEL)
    want = ref.fused_expand_ref(tt.prob, tt.edge_id, tt.tile_src,
                                tt.tile_dst, _t(fr), _t(vis), SEED, LEVEL)
    assert torch.equal(got, want) and bool(got[0].any())
    tq, q8 = tiles.quantized(gt, 64)
    got = ops.fused_expand_q(tq, q8, _t(fr), _t(vis), SEED, LEVEL)
    want = ref.fused_expand_q_ref(q8, tq.tile_src, tq.tile_dst, _t(fr),
                                  _t(vis), SEED, LEVEL)
    assert torch.equal(got, want) and bool(got[0].any())
