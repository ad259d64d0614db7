"""Port ≡ reference for the LT kernel's slot list.

``lt_select_expand`` walks a per-tile list of the slots with ``prob > 0``
(`repro_torch.core.tiles.lt_slot_list`), each entry carrying its
probability and, as its key, the float32 bits of its selection-CDF prefix
``cb``.  On CPU tensors `repro_torch.kernels.ops.lt_select_expand` runs the
plain version over that list (`kernels.ref.lt_select_expand_slots_ref`);
here it is held, word for word, against the tile-form plain version that
defines the result (`kernels.ref.lt_select_expand_ref`) and against the
reference's Pallas kernel in interpret mode, on the dense grid and on
compacted tile lists, at 1, 2, 4 and 8 words; the interval's two ends are
pinned; the list made from host arrays equals the one read from the
stacks; and whole LT traversals on both grids equal the reference's CSR
sweep.  The CUDA kernel is held against the same plain versions on the
GPU (`tests/test_torch_cuda.py`, ``chip_smoke.py``).  Tolerance: exact
everywhere (integer words, float32 bit patterns)."""
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lt as jlt
from repro.core import rrr as jrrr
from repro.core import tiles as jtiles
from repro.graph import csr as jcsr
from repro.kernels import lt_select_expand as jlse
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import lt as tlt
from repro_torch.core import tiled_traversal as ttt
from repro_torch.core import tiles
from repro_torch.kernels import ops, ref

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

SEED = 0xDEADBEEF


def _port(gj):
    return convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), gj.num_vertices, gj.num_edges, device="cpu")


def _graphs(src, dst, prob, n):
    """(reference, port) LT-normalised graphs of one edge list."""
    gj = jlt.normalize_lt_weights(jcsr.from_edges(src, dst, prob, n,
                                                  dedupe=True))
    return gj, tlt.normalize_lt_weights(_port(gj))


def _random(seed, *, n=300, e=1500, dst_limit=200):
    """A random LT graph pair whose destinations lie below ``dst_limit``
    (the blocks above get no tile)."""
    rs = np.random.default_rng(seed)
    src, dst = rs.integers(0, n, e), rs.integers(0, dst_limit, e)
    keep = src != dst
    return _graphs(src[keep], dst[keep],
                   rs.uniform(0.05, 0.9, keep.sum()).astype(np.float32), n)


def _hub(seed):
    """Destination row 0 takes ~300 in-edges (more than a warp's 32 lanes
    on the card), the rest a sprinkle of random edges."""
    n = 384
    rs = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, 301), rs.integers(0, n, 600)])
    dst = np.concatenate([np.zeros(300, np.int64), rs.integers(0, n, 600)])
    keep = src != dst
    return _graphs(src[keep], dst[keep],
                   rs.uniform(0.05, 0.9, keep.sum()).astype(np.float32), n)


def _tiles(gj, gt, tile_size=32, pad=0):
    """(reference tiles, reference cb, port tiles, port cb); the port's cb
    comes from `tiles.lt_cb_tiles`, which builds the list from its host
    arrays."""
    pad_to = jtiles.from_graph(gj, tile_size).num_tiles + pad if pad else None
    tj = jtiles.from_graph(gj, tile_size, pad_tiles_to=pad_to)
    tt = tiles.from_graph(gt, tile_size, pad_tiles_to=pad_to, edge_ids=False)
    cbj = jtiles.edge_values_to_tiles(tj, jlt.selection_cum_before(gj))
    cbt = tiles.lt_cb_tiles(tt, gt, tlt.selection_cum_before(gt))
    return tj, jnp.asarray(cbj), tt, cbt


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
    """(name, ascending int32 tile ids or None): the dense grid, then the
    compacted lists: empty, the tiles of one source block, every tile."""
    act = torch.zeros(tt.num_blocks, dtype=torch.bool)
    out = [("dense grid", None),
           ("empty", tiles.active_tile_ids(tt.tile_src, act))]
    act[int(tt.tile_src[0])] = True
    out.append(("one source block", tiles.active_tile_ids(tt.tile_src, act)))
    act[:] = True
    out.append(("full", tiles.active_tile_ids(tt.tile_src, act)))
    return out


def _first_of(tile_dst):
    """The reference's run-start flags of a gathered dst-sorted list."""
    return jnp.concatenate([jnp.ones((1,), jnp.int32),
                            (tile_dst[1:] != tile_dst[:-1]).astype(jnp.int32)])


def _pallas(tj, cbj, ids, fr, vis, u):
    """The reference's Pallas kernel in interpret mode over every tile
    (``ids`` None) or the gathered listed tiles."""
    if ids is None:
        prob, cb, ts, td, first = (tj.prob, cbj, tj.tile_src, tj.tile_dst,
                                   tj.first_of_dst)
    else:
        jid = jnp.asarray(ids.numpy())
        prob, cb, ts, td = (tj.prob[jid], cbj[jid], tj.tile_src[jid],
                            tj.tile_dst[jid])
        first = _first_of(td)
    return np.asarray(jlse.lt_select_expand(
        prob, cb, ts, td, first, jnp.asarray(fr), jnp.asarray(vis), u,
        interpret=True))


def _check_level(tj, cbj, tt, cbt, colors, fr, vis):
    """One LT level on every list of `_lists`: the list plain version (via
    the wrapper, on CPU tensors) ≡ the tile-form plain version on the same
    tiles ≡ the Pallas kernel.  Returns how many lists reached a vertex."""
    uj = jref.lt_selection_uniforms(jnp.uint32(SEED), tt.padded_vertices,
                                    colors)
    ut = ref.lt_selection_uniforms(SEED, tt.padded_vertices, colors)
    reached = 0
    for name, ids in _lists(tt):
        sel = slice(None) if ids is None else ids.long()
        got = convert.masks_to_numpy(ops.lt_select_expand(
            tt, cbt, _t(fr), _t(vis), ut, tile_ids=ids))
        tile_form = convert.masks_to_numpy(ref.lt_select_expand_ref(
            tt.prob[sel], cbt[sel], tt.tile_src[sel], tt.tile_dst[sel],
            _t(fr), _t(vis), ut))
        np.testing.assert_array_equal(got, tile_form, err_msg=name)
        if ids is not None and ids.numel() == 0:
            assert not got.any()
            continue
        np.testing.assert_array_equal(
            got, _pallas(tj, cbj, ids, fr, vis, uj), err_msg=name)
        reached += int(got.any())
    return reached


# ------------------------------------------------------------ one level
@pytest.mark.parametrize("colors", [32, 64, 128, 256])
def test_lt_list_equals_tiles_and_pallas_on_every_list(colors):
    """W 1/2/4/8, padding tiles, destination blocks no tile reaches; the
    dense grid and the empty, one-source-block and full lists."""
    gj, gt = _random(colors)
    tj, cbj, tt, cbt = _tiles(gj, gt, pad=4)
    assert tt.num_tiles == tj.prob.shape[0]
    assert tt.num_blocks > int(tt.tile_dst.max()) + 1
    fr, vis = _masks(tt.padded_vertices, colors, colors, 0.5)
    assert _check_level(tj, cbj, tt, cbt, colors, fr, vis) == 3


@pytest.mark.parametrize("tile_size", [32, 64])
@pytest.mark.parametrize("colors", [32, 256])
def test_lt_list_merges_a_hub_destination(tile_size, colors):
    """Row 0 with ~300 in-edges over every source block: its entries
    spread over many tiles and neighbouring entries share it."""
    gj, gt = _hub(tile_size + colors)
    tj, cbj, tt, cbt = _tiles(gj, gt, tile_size)
    assert int((tiles.lt_slot_list(tt, cbt).dst_row == 0).sum()) >= 250
    fr, vis = _masks(tt.padded_vertices, colors, colors, 0.9)
    vis[0] = fr[0] = 0
    assert _check_level(tj, cbj, tt, cbt, colors, fr, vis) == 3
    got = ops.lt_select_expand(tt, cbt, _t(fr), _t(vis),
                               ref.lt_selection_uniforms(
                                   SEED, tt.padded_vertices, colors))
    assert bool(got[0].any())


@pytest.mark.parametrize("prob", [(0.125, 0.25, 0.375, 0.125),
                                  (0.1, 0.2, 0.3, 0.15)])
def test_lt_interval_includes_cb_and_excludes_cb_plus_prob(prob):
    """Four in-edges of row 0; source k carries colours k and 4 + k, whose
    uniforms lie exactly at its edge's ``cb`` and exactly at ``cb + prob``
    (the float32 sum): colour k crosses, colour 4 + k does not — in the
    list plain version, the tile form and the Pallas kernel alike (with
    binary fractions and with sums that round)."""
    n = 64
    gj, gt = _graphs(np.array([1, 2, 3, 4]), np.zeros(4, np.int64),
                     np.asarray(prob, np.float32), n)
    tj, cbj, tt, cbt = _tiles(gj, gt)
    slots = tiles.lt_slot_list(tt, cbt)
    assert slots.num_entries == 4
    lo = slots.key.view(torch.float32)
    hi = lo + slots.value
    assert float(lo.min()) == 0.0 and bool((hi > lo).all())
    u = ref.lt_selection_uniforms(SEED, tt.padded_vertices, 64)
    fr = np.zeros((tt.padded_vertices, 2), np.uint32)
    for k in range(4):
        u[0, k], u[0, 4 + k] = lo[k], hi[k]
        fr[int(slots.src_row[k]), 0] = (1 << k) | (1 << (4 + k))
    vis = fr.copy()
    got = convert.masks_to_numpy(ops.lt_select_expand(tt, cbt, _t(fr),
                                                      _t(vis), u))
    tile_form = convert.masks_to_numpy(ref.lt_select_expand_ref(
        tt.prob, cbt, tt.tile_src, tt.tile_dst, _t(fr), _t(vis), u))
    pallas = np.asarray(jlse.lt_select_expand(
        tj.prob, cbj, tj.tile_src, tj.tile_dst, tj.first_of_dst,
        jnp.asarray(fr), jnp.asarray(vis), jnp.asarray(u.numpy()),
        interpret=True))
    np.testing.assert_array_equal(got, tile_form)
    np.testing.assert_array_equal(got, pallas)
    assert int(got[0, 0]) == 0x0F and int(got[0, 1]) == 0
    assert not got[1:].any()


# --------------------------------------------------- how the list is built
def _same(a, b):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), field.name
        else:
            assert x == y, field.name


@pytest.mark.parametrize("chunk_tiles", [1, 3, 1000])
def test_lt_list_from_host_arrays_equals_list_from_stacks(chunk_tiles,
                                                          monkeypatch):
    """`tiles.lt_cb_tiles` builds the list from its host arrays; a cb stack
    it did not build (a copy, here) is read in chunks of tiles: the two
    lists are the same, field for field, and hold exactly the slots with
    ``prob > 0``, valued by prob and keyed by cb's bits."""
    gj, gt = _random(7)
    _, _, tt, cbt = _tiles(gj, gt, pad=3)
    host = tiles.lt_slot_list(tt, cbt)
    monkeypatch.setattr(tiles, "SLOT_CHUNK", chunk_tiles * 32 * 32)
    copy = tiles.lt_slot_list(tt, cbt.clone())
    assert copy is not host
    _same(host, copy)
    _same(host, tiles.lt_slot_list_from_stack(tt, cbt))
    T = tt.tile_size
    counts = (tt.prob > 0).sum((1, 2))
    assert host.num_entries == int(counts.sum())
    tile = torch.repeat_interleave(torch.arange(tt.num_tiles), counts)
    i = host.src_row.long() - tt.tile_src[tile].long() * T
    j = host.dst_row.long() - tt.tile_dst[tile].long() * T
    assert bool((torch.diff(tile * T * T + j * T + i) > 0).all())
    assert torch.equal(host.value, tt.prob[tile, i, j])
    assert torch.equal(host.key, cbt[tile, i, j].view(torch.int32))


def test_lt_list_is_memoised_and_refuses_what_it_cannot_walk():
    gj, gt = _random(8)
    _, _, tt, cbt = _tiles(gj, gt)
    first = tiles.lt_slot_list(tt, cbt)
    assert tiles.lt_slot_list(tt, cbt) is first
    fr, vis = _masks(tt.padded_vertices, 64, 1, 0.3)
    ops.lt_select_expand(tt, cbt, _t(fr), _t(vis),
                         ref.lt_selection_uniforms(1, tt.padded_vertices, 64))
    assert tiles.lt_slot_list(tt, cbt) is first
    other = cbt.clone()
    assert torch.equal(other, cbt)
    assert tiles.lt_slot_list(tt, other) is not first
    with pytest.raises(ValueError, match="cb"):
        tiles.lt_slot_list(tt, cbt[:, :16].contiguous())
    with pytest.raises(ValueError, match="cb"):
        tiles.lt_slot_list(tt, cbt.double())
    tq, _ = tiles.quantized(gt, 32)
    with pytest.raises(ValueError, match="quantised"):
        tiles.lt_slot_list(tq, cbt)
    with pytest.raises(ValueError, match="quantised"):
        tiles.lt_cb_tiles(tq, gt, tlt.selection_cum_before(gt))
    with pytest.raises(ValueError, match="quantised"):
        ops.lt_select_expand(tq, cbt, _t(fr), _t(vis),
                             ref.lt_selection_uniforms(
                                 1, tt.padded_vertices, 64))


def test_lt_list_goes_with_its_cb_stack():
    """A memo entry goes when any of its tensors is collected: a cb stack
    dropped while its layout's prob lives takes its list with it, and a
    new cb stack for the same layout adds one entry, not one more each
    time."""
    gj, gt = _random(9)
    _, _, tt, cbt = _tiles(gj, gt)
    gc.collect()
    before = len(tiles._SLOT_LISTS)
    for _ in range(3):
        cb = tiles.lt_cb_tiles(tt, gt, tlt.selection_cum_before(gt))
        assert tiles.lt_slot_list(tt, cb) is not tiles.lt_slot_list(tt, cbt)
        assert len(tiles._SLOT_LISTS) == before + 1
        del cb
        gc.collect()
        assert len(tiles._SLOT_LISTS) == before
    copy = cbt.clone()
    tiles.lt_slot_list(tt, copy)
    assert len(tiles._SLOT_LISTS) == before + 1
    del copy
    gc.collect()
    assert len(tiles._SLOT_LISTS) == before
    assert tiles.lt_slot_list(tt, cbt) is tiles.lt_slot_list(tt, cbt)


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("frontier", ["dense", "sparse"])
@pytest.mark.parametrize("tile_size", [32, 128])
def test_lt_traversal_on_the_list_equals_the_reference_sweep(frontier,
                                                             tile_size):
    """`run_fused_lt_tiled` over the slot list, on the dense grid and the
    compacted lists, ≡ the reference's LT CSR sweep
    (``repro.core.lt.run_fused_lt``) for two batches of 64 colours."""
    from repro.graph import generators as jgen
    g = jcsr.dedupe(jgen.powerlaw_cluster(400, 6.0, prob=(0.1, 0.7),
                                          seed=tile_size))
    gj = jlt.normalize_lt_weights(jcsr.transpose(g))
    gt = tlt.normalize_lt_weights(_port(gj))
    _, _, tt, cbt = _tiles(gj, gt, tile_size)
    for b in range(2):
        starts = jrrr.batch_starts(400, 64, 0, b)
        seed = jrrr.batch_seed(0, b)
        want = np.asarray(jlt.run_fused_lt(gj, starts, 64, seed))
        got, levels, _ = ttt.run_fused_lt_tiled(
            tt, cbt, np.asarray(starts), 64, int(seed), frontier=frontier)
        np.testing.assert_array_equal(convert.masks_to_numpy(got), want)
        assert levels > 1 and want.any()
