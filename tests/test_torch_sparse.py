"""Port ≡ reference for the sparse-frontier slice: the edge-block index, the
capacity ladder and its rung choice, the sparse CSR engines (IC with every
`TraversalStats` field, LT, multi-batch blocks, the profile), the tile
compaction and the compacted tile grids, and the sampler matrix
{ic, lt} × {dense, tiled, kernel} × {dense, sparse}.  Exact throughout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro.core import lt as jlt
from repro.core import rrr as jrrr
from repro.core import sparse as jsparse
from repro.core import tiled_traversal as jtt
from repro.core import tiles as jtiles
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.kernels import fused_expand as jfe
from repro.kernels import lt_select_expand as jlse
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch import sampling as tsampling
from repro_torch.core import lt as tlt
from repro_torch.core import sparse as tsparse
from repro_torch.core import tiled_traversal as ttt
from repro_torch.core import tiles as ttiles
from repro_torch.graph import csr as tcsr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve_influence as tlaunch

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

_STATS = ("fused_edge_visits", "unfused_edge_visits", "frontier_vertices",
          "frontier_colors", "occupancy_num", "active_tile_frac",
          "grid_steps")


def _port(gj):
    return convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), gj.num_vertices, gj.num_edges, device="cpu")


def _rev_pair(n, prob, seed, pad=0):
    """(reference, port) reversed, deduped powerlaw graphs; ``pad`` CSR
    padding edges."""
    g = jcsr.dedupe(jgen.powerlaw_cluster(n, 6.0, prob=prob, seed=seed))
    if pad:
        e = g.num_edges
        g = jcsr.from_edges(np.asarray(g.src)[:e], np.asarray(g.dst)[:e],
                            np.asarray(g.prob)[:e], n, pad_to=e + pad)
    gj = jcsr.transpose(g)
    return gj, _port(gj)


def _fidx_pair(gj, gt, lt=False, **kw):
    cbj = jlt.selection_cum_before(gj) if lt else None
    cbt = tlt.selection_cum_before(gt) if lt else None
    return (jsparse.build_frontier_index(gj, cb=cbj, **kw),
            tsparse.build_frontier_index(gt, cb=cbt, **kw))


@pytest.mark.parametrize("tile_rows,edge_block,pad,lt",
                         [(128, 128, 0, False), (32, 16, 7, True),
                          (64, 8, 0, True), (8, 128, 3, False)])
def test_build_frontier_index_matches_reference(tile_rows, edge_block, pad,
                                                lt):
    gj, gt = _rev_pair(300, (0.1, 0.6), seed=tile_rows, pad=pad)
    if lt:
        gj, gt = jlt.normalize_lt_weights(gj), tlt.normalize_lt_weights(gt)
    fj, ft = _fidx_pair(gj, gt, lt, tile_rows=tile_rows,
                        edge_block=edge_block)
    nb = fj.num_blocks
    assert (ft.num_blocks, ft.num_vertices, ft.edge_block, ft.tile_rows) == \
        (nb, fj.num_vertices, fj.edge_block, fj.tile_rows)
    for name in ("blk_src", "blk_dst", "blk_eid", "blk_valid"):
        want = np.asarray(getattr(fj, name))
        np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                      want[:nb].astype(
                                          getattr(ft, name).numpy().dtype),
                                      err_msg=name)
        assert not want[nb].any()                 # the reference's null block
    for name in ("blk_prob",) + (("blk_cb",) if lt else ()):
        np.testing.assert_array_equal(
            getattr(ft, name).numpy().view(np.uint32),
            np.asarray(getattr(fj, name))[:nb].view(np.uint32), err_msg=name)
    np.testing.assert_array_equal(ft.blk_rowblock.numpy(),
                                  np.asarray(fj.blk_rowblock))
    assert int(ft.blk_valid.sum()) == gt.padded_edges
    assert (ft.blk_cb is None) == (not lt)


def test_bucket_ladder_and_rung_match_reference():
    """The ladder over many (n, capacity), and ``ladder_rung`` ≡ the rung
    the reference's ``cond_ladder`` runs, for every count up to n."""
    for n in (0, 1, 2, 7, 8, 9, 63, 64, 65, 500, 512, 513, 4096, 198264):
        for cap in (0, 1, 3, 7, 8, 100, 1000, 10 ** 6):
            want = jsparse.bucket_ladder(n, cap)
            assert tsparse.bucket_ladder(n, cap) == want, (n, cap)
    for ladder in ((1, 9), (2, 16, 40), (40,), jsparse.bucket_ladder(600)):
        rung = jax.jit(jax.vmap(lambda c, lad=ladder: jsparse.cond_ladder(
            c, lad, lambda k: (lambda _: jnp.int32(k)))))
        counts = np.arange(ladder[-1] + 1, dtype=np.int32)
        want = np.asarray(rung(counts))
        got = [tsparse.ladder_rung(int(c), ladder) for c in counts]
        np.testing.assert_array_equal(got, want)


def test_row_block_activity_and_active_tile_ids_match_reference():
    gj, gt = _rev_pair(300, 0.3, seed=3)
    tj, tt = jtiles.from_graph(gj, 32), ttiles.from_graph(gt, 32)
    rs = np.random.default_rng(0)
    for density in (0.0, 0.01, 0.2):
        lanes = rs.random((tt.padded_vertices, 2, 32)) < density
        fr = np.packbits(lanes, axis=-1, bitorder="little") \
            .view(np.uint32)[..., 0]
        act_j = jsparse.row_block_activity(jnp.asarray(fr), 32)
        act_t = tsparse.row_block_activity(
            convert.masks_from_numpy(fr, "cpu"), 32)
        np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_j))
        cap = tj.num_tiles
        ids_j = np.asarray(jtiles.active_tile_ids(tj.tile_src, act_j, cap,
                                                  tj.num_tiles))
        ids_t = ttiles.active_tile_ids(tt.tile_src, act_t).numpy()
        count = len(ids_t)
        np.testing.assert_array_equal(ids_t, ids_j[:count])
        assert (ids_j[count:] == tj.num_tiles).all()   # the null padding
        assert ids_t.dtype == np.int32


@pytest.mark.parametrize("n,prob,colors,max_levels,tile_rows,ladder",
                         [(300, 0.25, 64, 64, 128, None),
                          (450, (0.0, 1.0), 96, 64, 64, None),
                          (300, 0.6, 32, 5, 32, (1, None)),
                          (250, (0.1, 0.6), 64, 64, 64, (2, 16, None)),
                          (200, 0.4, 40, 12, 16, "cap7")])
def test_run_fused_sparse_matches_reference(n, prob, colors, max_levels,
                                            tile_rows, ladder):
    """Masks and every `TraversalStats` field, ``grid_steps`` included,
    over auto, explicit and degenerate ladders."""
    gj, gt = _rev_pair(n, prob, seed=n, pad=5)
    fj, ft = _fidx_pair(gj, gt, tile_rows=tile_rows)
    nb = fj.num_blocks
    if ladder == "cap7":
        ladder = jsparse.bucket_ladder(nb, capacity=7)
    elif ladder is not None:
        ladder = tuple(nb if k is None else k for k in ladder)
    for b in range(2):
        starts = jrrr.batch_starts(n, colors, 0, b)
        seed = jrrr.batch_seed(0, b)
        rj = jsparse.run_fused_sparse(fj, starts, colors, seed,
                                      max_levels=max_levels, ladder=ladder)
        rt = tsparse.run_fused_sparse(ft, np.asarray(starts), colors,
                                      int(seed), max_levels=max_levels,
                                      ladder=ladder)
        np.testing.assert_array_equal(convert.masks_to_numpy(rt.visited),
                                      np.asarray(rj.visited))
        assert rt.stats.levels_run == int(rj.stats.levels_run)
        for f in _STATS:
            np.testing.assert_array_equal(getattr(rt.stats, f),
                                          np.asarray(getattr(rj.stats, f)),
                                          err_msg=f)


@pytest.mark.parametrize("tile_rows,colors", [(128, 64), (32, 96)])
def test_run_fused_lt_sparse_and_blocks_match_reference(tile_rows, colors):
    gj, gt = _rev_pair(300, (0.1, 0.9), seed=tile_rows + colors)
    gj, gt = jlt.normalize_lt_weights(gj), tlt.normalize_lt_weights(gt)
    fj, ft = _fidx_pair(gj, gt, lt=True, tile_rows=tile_rows)
    ladder = jsparse.bucket_ladder(fj.num_blocks)
    idx = [0, 1, 2]
    starts = np.stack([np.asarray(jrrr.batch_starts(300, colors, 2, b))
                       for b in idx])
    seeds = jrrr.batch_seeds(2, idx)
    for diffusion in ("lt", "ic"):
        vj, fuj, uj = jsparse.sparse_block(fj, starts, seeds, colors, 64,
                                           ladder, diffusion=diffusion)
        vt, fut, ut = tsparse.sparse_block(ft, starts, seeds, colors, 64,
                                           ladder, diffusion=diffusion)
        np.testing.assert_array_equal(convert.masks_to_numpy(vt),
                                      np.asarray(vj))
        np.testing.assert_array_equal(fut, np.asarray(fuj))
        np.testing.assert_array_equal(ut, np.asarray(uj))
    one_j = jsparse.run_fused_lt_sparse(fj, starts[1], colors, seeds[1])
    one_t = tsparse.run_fused_lt_sparse(ft, starts[1], colors, int(seeds[1]))
    np.testing.assert_array_equal(convert.masks_to_numpy(one_t),
                                  np.asarray(one_j))
    np.testing.assert_array_equal(
        convert.masks_to_numpy(one_t),
        convert.masks_to_numpy(tlt.run_fused_lt(gt, starts[1], colors,
                                                int(seeds[1]))))


@pytest.mark.parametrize("diffusion", ["ic", "lt"])
def test_profile_traversal_matches_reference(diffusion):
    gj, gt = _rev_pair(300, 0.3, seed=8)
    if diffusion == "lt":
        gj, gt = jlt.normalize_lt_weights(gj), tlt.normalize_lt_weights(gt)
    fj, ft = _fidx_pair(gj, gt, lt=diffusion == "lt", tile_rows=32)
    starts = jrrr.batch_starts(300, 64, 1, 0)
    seed = jrrr.batch_seed(1, 0)
    want = jsparse.profile_traversal(fj, starts, 64, seed,
                                     diffusion=diffusion)
    got = tsparse.profile_traversal(ft, np.asarray(starts), 64, int(seed),
                                    diffusion=diffusion)
    assert got == want and len(got) > 1


def _tiles_pair(gj, gt, tile_size, pad=0):
    nt = jtiles.from_graph(gj, tile_size).num_tiles
    pad_to = nt + pad if pad else None
    return (jtiles.from_graph(gj, tile_size, pad_tiles_to=pad_to),
            ttiles.from_graph(gt, tile_size, pad_tiles_to=pad_to))


@pytest.mark.parametrize("tile_size,pad", [(32, 0), (64, 5), (128, 0)])
def test_run_fused_tiled_sparse_matches_reference(tile_size, pad):
    """IC on the compacted tile grid ≡ the reference's runner on masks,
    levels and grid_steps (padding tiles included), ≡ the dense grid."""
    gj, gt = _rev_pair(300, 0.4, seed=tile_size)
    tj, tt = _tiles_pair(gj, gt, tile_size, pad)
    for b in range(2):
        starts = jrrr.batch_starts(300, 64, 0, b)
        seed = jrrr.batch_seed(0, b)
        vj, lj, gsj = jtt.run_fused_tiled(tj, starts, 64, seed,
                                          use_kernel=False, frontier="sparse")
        work = {}
        vt, lvl, gst = ttt.run_fused_tiled(tt, np.asarray(starts), 64,
                                           int(seed), frontier="sparse",
                                           work=work)
        np.testing.assert_array_equal(convert.masks_to_numpy(vt),
                                      np.asarray(vj))
        assert (lvl, gst) == (int(lj), int(gsj))
        assert len(work["active_tiles"]) == lvl
        dense, _, gsd = ttt.run_fused_tiled(tt, np.asarray(starts), 64,
                                            int(seed))
        assert torch.equal(vt, dense) and gst <= gsd


def _expand_masks(vp, seed, density):
    rs = np.random.default_rng(seed)
    lanes = rs.random((2, vp, 2, 32)) < [[[[density]]], [[[0.2]]]]
    words = np.packbits(lanes, axis=-1, bitorder="little") \
        .view(np.uint32)[..., 0]
    return words[0], words[0] | words[1]


@pytest.mark.parametrize("active", ["none", "one", "all"])
def test_tile_list_expansion_matches_reference_gather(active):
    """Both plain versions on a tile list ≡ the reference's Pallas kernels
    on its gathered, null-padded stacks (`tiled_traversal._sparse_tile_
    expand`): an empty list, one source block, and every tile."""
    gj, gt = _rev_pair(300, (0.2, 0.9), seed=11)
    gj, gt = jlt.normalize_lt_weights(gj), tlt.normalize_lt_weights(gt)
    tj, tt = _tiles_pair(gj, gt, 32, pad=3)
    cbj = jnp.asarray(jtiles.edge_values_to_tiles(
        tj, jlt.selection_cum_before(gj)))
    cbt = ttiles.lt_cb_tiles(tt, gt, tlt.selection_cum_before(gt))
    fr, vis = _expand_masks(tt.padded_vertices, 3, 0.3)
    act = np.zeros(tt.num_blocks, bool)
    act[{"none": [], "one": [2], "all": slice(None)}[active]] = True
    fr[np.repeat(~act, 32)] = 0
    ids = ttiles.active_tile_ids(tt.tile_src, torch.from_numpy(act))
    if active == "one":
        assert 0 < len(ids) < tt.num_tiles
    else:
        assert len(ids) == {"none": 0, "all": tt.num_tiles}[active]
    tgn = jtiles.with_null_tile(tj)
    idj = jtiles.active_tile_ids(tj.tile_src, jnp.asarray(act), tj.num_tiles,
                                 tj.num_tiles)
    first = jtt._gathered_first_of_dst(tgn.tile_dst[idj])
    cbn = jnp.concatenate([cbj, jnp.zeros((1, 32, 32), jnp.float32)])
    u = jref.lt_selection_uniforms(jnp.uint32(4), tt.padded_vertices, 64)
    frj, visj = jnp.asarray(fr), jnp.asarray(vis)
    want_ic = jfe.fused_expand(tgn.prob[idj], tgn.edge_id[idj],
                               tgn.tile_src[idj], tgn.tile_dst[idj], first,
                               frj, visj, jnp.uint32(9), jnp.uint32(2),
                               interpret=True)
    want_lt = jlse.lt_select_expand(tgn.prob[idj], cbn[idj],
                                    tgn.tile_src[idj], tgn.tile_dst[idj],
                                    first, frj, visj, u, interpret=True)
    frt = convert.masks_from_numpy(fr, "cpu")
    vist = convert.masks_from_numpy(vis, "cpu")
    got_ic = tops.fused_expand(tt, frt, vist, 9, 2, tile_ids=ids)
    got_lt = tops.lt_select_expand(
        tt, cbt, frt, vist, tref.lt_selection_uniforms(
            4, tt.padded_vertices, 64), tile_ids=ids)
    np.testing.assert_array_equal(convert.masks_to_numpy(got_ic),
                                  np.asarray(want_ic))
    np.testing.assert_array_equal(convert.masks_to_numpy(got_lt),
                                  np.asarray(want_lt))
    assert bool(got_ic.any()) == (active != "none")
    # The run pointers the CUDA wrappers build over the list.
    ptr = ttiles.run_pointers(tt.tile_dst[ids.long()], tt.num_blocks)
    assert ptr.dtype == torch.int32 and int(ptr[-1]) == len(ids)
    np.testing.assert_array_equal(
        np.diff(ptr.numpy()),
        np.bincount(tt.tile_dst[ids.long()].numpy(),
                    minlength=tt.num_blocks))


@pytest.fixture(scope="module")
def graph_pair():
    """Dedupe-clean graph (the tile layout needs parallel edges merged)."""
    gj = jcsr.dedupe(jgen.powerlaw_cluster(250, 6.0, prob=(0.1, 0.6),
                                           seed=23))
    e = gj.num_edges
    gt = tcsr.from_edges(np.asarray(gj.src)[:e], np.asarray(gj.dst)[:e],
                         np.asarray(gj.prob)[:e], gj.num_vertices,
                         device="cpu")
    return gj, gt


@pytest.mark.parametrize("diffusion", ["ic", "lt"])
@pytest.mark.parametrize("backend", ["dense", "tiled", "kernel"])
@pytest.mark.parametrize("frontier", ["dense", "sparse"])
def test_sampler_matrix_matches_reference(graph_pair, diffusion, backend,
                                          frontier):
    """Batches 0-3 of every single-device cell ≡ the reference's sampler
    (edge-visit counters and, on tile backends, ``last_levels`` and
    ``last_grid_steps`` too)."""
    gj, gt = graph_pair
    kw = dict(diffusion=diffusion, backend=backend, num_colors=64,
              master_seed=5, frontier=frontier)
    sj = jsampling.make_sampler(gj, jsampling.SamplerSpec(**kw))
    st = tsampling.make_sampler(gt, tsampling.SamplerSpec(**kw))
    many_j, many_t = sj.sample_many(range(4)), st.sample_many(range(4))
    for bj, bt in zip(many_j, many_t):
        np.testing.assert_array_equal(convert.masks_to_numpy(bt.visited),
                                      np.asarray(bj.visited))
        np.testing.assert_array_equal(bt.roots, np.asarray(bj.roots))
        assert (bt.fused_edge_visits, bt.unfused_edge_visits) == \
            (bj.fused_edge_visits, bj.unfused_edge_visits)
    if backend != "dense":
        for b in (0, 3):
            sj.sample(b)
            st.sample(b)
            assert (st.last_levels, st.last_grid_steps) == \
                (sj.last_levels, sj.last_grid_steps)
            assert 0 < st.last_active_tiles <= st.last_grid_steps


def test_port_launcher_sparse_smoke_on_cpu(capsys):
    """IC ``--frontier sparse`` on the kernel backend: the smoke holds the
    pool against the dense-frontier CSR pool and passes."""
    out = tlaunch.run_single(tlaunch.parse_args(
        ["--device", "cpu", "--smoke", "--frontier", "sparse",
         "--sampler-backend", "kernel"]))
    text = capsys.readouterr().out
    assert "dense-frontier reference pool bit for bit" in text
    assert "[smoke] PASS" in text and out["store"].spec.frontier == "sparse"
