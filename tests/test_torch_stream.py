"""Port ≡ reference for streaming graph updates (``tests/test_stream.py``,
test for test): id-stable delta application, dirty-slot tracking,
incremental refresh ≡ cold rebuild ≡ the reference's incremental pool on
every ported backend, the values-only frontier-index patch, compaction,
and the serving tier's write path.  Every value is compared bit for bit."""
import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro.core import lt as jlt
from repro.core import sparse as jsparse
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.sampling import SamplerSpec as JSpec
from repro.sampling import make_sampler as jmake_sampler
from repro.serve.influence import PoolConfig as JPoolConfig
from repro.serve.influence import SketchStore as JStore
from repro_torch import convert
from repro_torch import stream as tstream
from repro_torch.core import lt as tlt
from repro_torch.core import sparse as tsparse
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.sampling import SamplerSpec as TSpec
from repro_torch.sampling import make_sampler as tmake_sampler
from repro_torch.serve.influence import PoolConfig as TPoolConfig
from repro_torch.serve.influence import SketchStore as TStore
from repro_torch.serve.tier import EpochMixError, ServingTier, ShedError

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

BACKENDS = ("dense", "tiled", "kernel")


def _pair(n=300, prob=(0.05, 0.3), seed=17, deg=6.0):
    """(reference graph, port graph) of one dedupe-clean powerlaw graph."""
    gj = jcsr.dedupe(jgen.powerlaw_cluster(n, deg, prob=prob, seed=seed))
    gt = tcsr.dedupe(tgen.powerlaw_cluster(n, deg, prob=prob, seed=seed,
                                           device="cpu"))
    _assert_same_graph(gj, gt)
    return gj, gt


@pytest.fixture(scope="module")
def graphs():
    return _pair()


def _arrays(g):
    """Every array a bit-identity claim is made over, padding included."""
    if isinstance(g.src, torch.Tensor):
        return (g.src.numpy(), g.dst.numpy(), g.prob.numpy(),
                g.indptr.numpy(), g.num_edges, g.padded_edges)
    return (np.asarray(g.src), np.asarray(g.dst), np.asarray(g.prob),
            np.asarray(g.indptr), g.num_edges, g.padded_edges)


def _assert_same_graph(a, b):
    for x, y in zip(_arrays(a), _arrays(b)):
        np.testing.assert_array_equal(x, y)


def _assert_same_applied(aj, at):
    np.testing.assert_array_equal(at.touched_rows, aj.touched_rows)
    assert at.touched_rows.dtype == np.int32
    for f in ("inserted", "deleted", "resurrected", "appended", "trimmed"):
        assert getattr(at, f) == getattr(aj, f), f


def _absent_pairs(g, count, seed=0):
    src, dst, _ = _arrays(g)[:3]
    e = g.num_edges
    taken = set(zip(src[:e].tolist(), dst[:e].tolist()))
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < count:
        s, d = (int(x) for x in rng.integers(0, g.num_vertices, 2))
        if s != d and (s, d) not in taken:
            taken.add((s, d))
            pairs.append((s, d))
    return pairs


def _both(fn, *deltas):
    """``fn`` on the reference's and on the port's delta type."""
    return fn(jstream), fn(tstream)


def _spec_kw(diffusion="ic", frontier="dense", colors=32, tile=64, seed=9):
    return dict(diffusion=diffusion, num_colors=colors, master_seed=seed,
                tile_size=tile, frontier=frontier)


def _tstore(g, *, backend="dense", batches=6, **kw):
    store = TStore(g, TPoolConfig(max_batches=16, spec=TSpec(
        backend=backend, **_spec_kw(**kw))))
    store.ensure(batches)
    return store


def _jstore(g, *, batches=6, **kw):
    store = JStore(g, JPoolConfig(max_batches=16, spec=JSpec(
        backend="dense", **_spec_kw(**kw))))
    store.ensure(batches)
    return store


def _assert_same_batches(tbatches, jbatches, visits=True):
    assert len(tbatches) == len(jbatches)
    for t, j in zip(tbatches, jbatches):
        assert t.batch_index == j.batch_index
        np.testing.assert_array_equal(convert.masks_to_numpy(t.visited),
                                      np.asarray(j.visited))
        if visits:
            assert (t.fused_edge_visits, t.unfused_edge_visits) == \
                (j.fused_edge_visits, j.unfused_edge_visits)


def _assert_equals_cold(store):
    cold = tstream.cold_rebuild_batches(store)
    for got, want in zip(store.batches, cold):
        assert torch.equal(got.visited, want.visited)
        assert (got.fused_edge_visits, got.unfused_edge_visits) == \
            (want.fused_edge_visits, want.unfused_edge_visits)
    assert torch.equal(store.visited_stack(),
                       torch.stack([b.visited for b in cold]))


# --------------------------------------------------------------- EdgeDelta
def test_edge_delta_validation_and_views():
    d = tstream.EdgeDelta.concat(
        tstream.EdgeDelta.inserts([1, 2], [3, 4], [0.5, 0.25]),
        tstream.EdgeDelta.deletes([7], [8]))
    assert (len(d), d.num_inserts, d.num_deletes) == (3, 2, 1)
    r = d.reversed()
    np.testing.assert_array_equal(r.src, d.dst)
    np.testing.assert_array_equal(r.dst, d.src)
    inv = tstream.EdgeDelta.inserts([1], [2], [0.5]).inverse()
    assert inv.num_deletes == 1 and not inv.insert.any()
    assert d.src.dtype == np.int32 and d.weight.dtype == np.float32

    with pytest.raises(ValueError, match="share one length"):
        tstream.EdgeDelta([1, 2], [3], [0.5], [True])
    for w in (0.0, -1.0, np.inf, np.nan):
        with pytest.raises(ValueError, match="finite and > 0"):
            tstream.EdgeDelta.inserts([1], [2], [w])
    with pytest.raises(ValueError, match="duplicate"):
        tstream.EdgeDelta.concat(tstream.EdgeDelta.inserts([1], [2], [0.5]),
                                 tstream.EdgeDelta.deletes([1], [2]))
    with pytest.raises(ValueError, match="all-insert"):
        tstream.EdgeDelta.deletes([1], [2]).inverse()


def test_apply_delta_rejects_bad_ops(graphs):
    _, g = graphs
    e = g.num_edges
    s0, d0 = int(g.src[0]), int(g.dst[0])
    (sa, da), = _absent_pairs(g, 1)
    with pytest.raises(KeyError, match="absent"):
        tstream.apply_delta(g, tstream.EdgeDelta.deletes([sa], [da]))
    with pytest.raises(KeyError, match="live"):
        tstream.apply_delta(g, tstream.EdgeDelta.inserts([s0], [d0], [0.5]))
    with pytest.raises(ValueError, match="outside"):
        tstream.apply_delta(g, tstream.EdgeDelta.deletes(
            [g.num_vertices], [0]))
    assert g.num_edges == e, "apply_delta must be functional"


# ----------------------------------------------------- round-trip property
_RT = _pair(200, seed=3, deg=5.0)
_RT_POOL = _absent_pairs(_RT[1], 64)


@pytest.mark.parametrize("seed", range(6))
def test_insert_then_inverse_roundtrip_is_bit_identical(seed):
    """apply_delta(apply_delta(g, ins), inverse) restores g bit for bit,
    array lengths included; every step equals the reference's."""
    gj, gt = _RT
    draws = np.random.default_rng(seed).integers(0, 2 ** 30, 1 + seed)
    pairs = sorted({_RT_POOL[v % len(_RT_POOL)] for v in draws})
    mk = lambda m: m.EdgeDelta.inserts(  # noqa: E731
        [p[0] for p in pairs], [p[1] for p in pairs],
        np.linspace(0.05, 0.4, len(pairs)))
    ins_j, ins_t = _both(mk)
    gj1, aj1 = jstream.apply_delta(gj, ins_j)
    gt1, at1 = tstream.apply_delta(gt, ins_t)
    _assert_same_graph(gj1, gt1)
    _assert_same_applied(aj1, at1)
    assert at1.appended == len(pairs)
    gj2, aj2 = jstream.apply_delta(gj1, ins_j.inverse())
    gt2, at2 = tstream.apply_delta(gt1, ins_t.inverse())
    _assert_same_graph(gj2, gt2)
    _assert_same_applied(aj2, at2)
    assert at2.trimmed >= len(pairs)
    _assert_same_graph(gt2, gt)


_LT_RT = tuple(m.normalize_lt_weights(g) for m, g in zip(
    (jlt, tlt), _pair(200, prob=(0.01, 0.02), seed=5, deg=5.0)))
_LT_RT_POOL = _absent_pairs(_LT_RT[1], 48)


@pytest.mark.parametrize("seed", range(4))
def test_lt_roundtrip_bit_identical_while_sums_stay_below_one(seed):
    gj, gt = _LT_RT
    _assert_same_graph(gj, gt)
    draws = np.random.default_rng(seed).integers(0, 2 ** 30, 2 + seed)
    pairs = sorted({_LT_RT_POOL[v % len(_LT_RT_POOL)] for v in draws})
    mk = lambda m: m.EdgeDelta.inserts(  # noqa: E731
        [p[0] for p in pairs], [p[1] for p in pairs],
        np.full(len(pairs), 1e-4, np.float32))
    ins_j, ins_t = _both(mk)
    gj1, _ = jstream.apply_delta(gj, ins_j, lt_normalized=True)
    gt1, _ = tstream.apply_delta(gt, ins_t, lt_normalized=True)
    _assert_same_graph(gj1, gt1)
    gt2, _ = tstream.apply_delta(gt1, ins_t.inverse(), lt_normalized=True)
    _assert_same_graph(gt2, gt)


def test_tombstone_then_resurrect_restores_bits(graphs):
    gj, gt = graphs
    e = gt.num_edges
    pos = np.array([5, 40, e - 100])
    s, d, w = (a.numpy()[pos] for a in (gt.src, gt.dst, gt.prob))
    g1, a1 = tstream.apply_delta(gt, tstream.EdgeDelta.deletes(s, d))
    gj1, aj1 = jstream.apply_delta(gj, jstream.EdgeDelta.deletes(s, d))
    _assert_same_graph(gj1, g1)
    _assert_same_applied(aj1, a1)
    assert a1.deleted == 3 and a1.trimmed == 0
    assert g1.prob.numpy()[pos].tolist() == [0.0] * 3, "tombstones"
    assert torch.equal(g1.src, gt.src)
    g2, a2 = tstream.apply_delta(g1, tstream.EdgeDelta.inserts(s, d, w))
    assert a2.resurrected == 3 and a2.appended == 0
    _assert_same_graph(g2, gt)


def test_fresh_insert_and_trim_are_population_neutral(graphs):
    _, g = graphs
    pad = g.padded_edges - g.num_edges
    pairs = _absent_pairs(g, 4, seed=2)
    ins = tstream.EdgeDelta.inserts([p[0] for p in pairs],
                                    [p[1] for p in pairs], [0.1] * 4)
    g1, a1 = tstream.apply_delta(g, ins)
    assert a1.appended == 4
    assert g1.padded_edges - g1.num_edges == pad
    assert 0 not in set(a1.touched_rows.tolist()) - {p[0] for p in pairs}
    g2, a2 = tstream.apply_delta(g1, ins.inverse())
    assert a2.trimmed >= 4
    assert g2.padded_edges - g2.num_edges == pad
    _assert_same_graph(g2, g)


def test_touched_rows_and_blocks(graphs):
    gj, gt = graphs
    e = gt.num_edges
    s0, d0 = int(gt.src[7]), int(gt.dst[7])
    _, a = tstream.apply_delta(gt, tstream.EdgeDelta.deletes([s0], [d0]))
    assert s0 in a.touched_rows
    blocks = tstream.touched_row_blocks(a.touched_rows, 64)
    assert s0 // 64 in blocks
    np.testing.assert_array_equal(
        blocks, jstream.touched_row_blocks(a.touched_rows, 64))
    gn, gjn = tlt.normalize_lt_weights(gt), jlt.normalize_lt_weights(gj)
    _, an = tstream.apply_delta(gn, tstream.EdgeDelta.deletes([s0], [d0]),
                                lt_normalized=True)
    _, ajn = jstream.apply_delta(gjn, jstream.EdgeDelta.deletes([s0], [d0]),
                                 lt_normalized=True)
    _assert_same_applied(ajn, an)
    dst, prob = gn.dst.numpy()[:e], gn.prob.numpy()[:e]
    peers = set(gn.src.numpy()[:e][(dst == d0) & (prob > 0)].tolist())
    assert peers - {s0} <= set(an.touched_rows.tolist())


def test_confined_lt_renorm_matches_full_normalize(graphs):
    gj, gt = graphs
    gn, gjn = tlt.normalize_lt_weights(gt), jlt.normalize_lt_weights(gj)
    dt = tstream.random_delta(gn, np.random.default_rng(4), num_deletes=6,
                              num_inserts=6, weight_range=(0.3, 0.9))
    dj = jstream.random_delta(gjn, np.random.default_rng(4), num_deletes=6,
                              num_inserts=6, weight_range=(0.3, 0.9))
    for f in ("src", "dst", "weight", "insert"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    fused, _ = tstream.apply_delta(gn, dt, lt_normalized=True)
    structural, _ = tstream.apply_delta(gn, dt)
    _assert_same_graph(fused, tlt.normalize_lt_weights(structural))
    _assert_same_graph(fused, jstream.apply_delta(gjn, dj,
                                                  lt_normalized=True)[0])


def test_normalize_lt_weights_is_order_preserving_and_idempotent(graphs):
    gj, gt = graphs
    pairs = _absent_pairs(gt, 3, seed=6)
    g1, _ = tstream.apply_delta(gt, tstream.EdgeDelta.inserts(
        *zip(*pairs), [0.9, 0.8, 0.7]))
    gn = tlt.normalize_lt_weights(g1)
    for name in ("src", "dst", "indptr"):
        assert torch.equal(getattr(gn, name), getattr(g1, name))
    e = gn.num_edges
    in_sum = np.zeros(gn.num_vertices)
    np.add.at(in_sum, gn.dst.numpy()[:e], gn.prob.numpy()[:e].astype(
        np.float64))
    assert in_sum.max() <= 1.0 + 1e-6
    _assert_same_graph(tlt.normalize_lt_weights(gn), gn)
    gj1, _ = jstream.apply_delta(gj, jstream.EdgeDelta.inserts(
        *zip(*pairs), [0.9, 0.8, 0.7]))
    _assert_same_graph(jlt.normalize_lt_weights(gj1), gn)


@pytest.mark.parametrize("rows", [None, (64, 192)])
def test_random_delta_matches_reference_and_is_confined(graphs, rows):
    """The same numpy seed draws the same delta in both packages, and it
    applies to the same graph, touched rows and counts."""
    gj, gt = graphs
    kw = dict(num_deletes=5, num_inserts=5,
              dst_rows=None if rows is None else np.arange(*rows))
    dt = tstream.random_delta(gt, np.random.default_rng(11), **kw)
    dj = jstream.random_delta(gj, np.random.default_rng(11), **kw)
    for f in ("src", "dst", "weight", "insert"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    assert dt.num_deletes == 5 and dt.num_inserts == 5
    if rows is not None:
        assert np.isin(dt.dst, np.arange(*rows)).all()
    g1, a1 = tstream.apply_delta(gt, dt)
    gj1, aj1 = jstream.apply_delta(gj, dj)
    _assert_same_graph(gj1, g1)
    _assert_same_applied(aj1, a1)
    assert g1.cache == {} and g1 is not gt


# ---------------------------------------------------------------- tracker
def test_tracker_records_queries_and_stats(graphs):
    gj, gt = graphs
    store = _tstore(gt, frontier="sparse")
    tracker = tstream.DirtySlotTracker.for_store(store)
    jtracker = jstream.DirtySlotTracker.for_store(
        _jstore(gj, frontier="sparse"))
    np.testing.assert_array_equal(tracker._bits, jtracker._bits)
    assert tracker.num_slots == len(store.batches)
    assert tracker.num_row_blocks == -(-gt.num_vertices // 64)
    vis = convert.masks_to_numpy(store.batches[0].visited)
    rows = np.nonzero((vis != 0).any(axis=1))[0]
    np.testing.assert_array_equal(tracker.visited_blocks(0),
                                  np.unique(rows // 64))
    assert 0 in tracker.dirty_slots([int(rows[0]) // 64])
    assert tracker.dirty_slots([3, 4]) == jtracker.dirty_slots([3, 4])
    with pytest.raises(ValueError, match="row block outside"):
        tracker.dirty_slots([tracker.num_row_blocks])
    stats = tracker.stats()
    assert stats == jtracker.stats()
    assert stats["tracker_bytes"] == tracker._bits.nbytes
    assert stats["mean_visited_blocks"] > 0


def test_tracker_sync_rerecords_only_changed_slots(graphs):
    _, gt = graphs
    store = _tstore(gt)
    tracker = tstream.DirtySlotTracker.for_store(store)
    assert tracker.sync(store) == 0, "clean re-sync is free"
    refreshed = store.refresh(fraction=0.34)
    assert tracker.sync(store) == len(refreshed)
    store.shrink(3)
    tracker.sync(store)
    assert tracker.num_slots == 3
    store.ensure(5)
    assert tracker.sync(store) == 2
    store.graph_epoch += 1
    assert tracker.sync(store) == 5


# ---------------------------------------------------- incremental refresh
def _mutations(g):
    """Two deltas on ``g``'s pair: fresh inserts (appended, so the edge
    arrays leave src order) with deletes (interior tombstones), then the
    deletion of the last appended edge (a trailing tombstone, trimmed)
    with one more delete."""
    rng = np.random.default_rng(21)
    first = tstream.random_delta(g, rng, num_deletes=4, num_inserts=4)
    last = (int(first.src[first.insert][-1]),
            int(first.dst[first.insert][-1]))
    return first, rng, last


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("diffusion,frontier", [("ic", "dense"),
                                                ("ic", "sparse"),
                                                ("lt", "sparse")])
def test_incremental_refresh_matches_cold_rebuild(graphs, backend, diffusion,
                                                  frontier):
    """Inserts, deletes and a trim on an unsorted, tombstoned pair: the
    port's incremental pool equals its cold rebuild and the reference's
    incremental pool (dense backend) bit for bit, on every backend."""
    gj, gt = graphs
    kw = dict(diffusion=diffusion, frontier=frontier)
    store = _tstore(gt, backend=backend, **kw)
    jstore = _jstore(gj, **kw)
    store.visited_stack()
    jstore.visited_stack()
    tracker = tstream.DirtySlotTracker.for_store(store)
    jtracker = jstream.DirtySlotTracker.for_store(jstore)
    first, _, last = _mutations(store.graph)
    v0 = store.version
    for step in range(2):
        if step == 0:
            dt = first
        else:
            rng = np.random.default_rng(22)
            extra = tstream.random_delta(store.graph, rng, num_deletes=1,
                                         num_inserts=0)
            dt = tstream.EdgeDelta.concat(
                tstream.EdgeDelta.deletes([last[0]], [last[1]]), extra)
        dj = jstream.EdgeDelta(dt.src, dt.dst, dt.weight, dt.insert)
        report = tstream.incremental_refresh(store, tracker, dt)
        jreport = jstream.incremental_refresh(jstore, jtracker, dj)
        assert report.graph_epoch == store.graph_epoch == step + 1
        assert (report.dirty_slots, report.touched_row_blocks) == \
            (jreport.dirty_slots, jreport.touched_row_blocks)
        assert 0 < report.dirty_slots <= report.total_slots
        _assert_same_graph(jstore.graph, store.graph)
        _assert_equals_cold(store)
        _assert_same_batches(store.batches, jstore.batches,
                             visits=backend == "dense")
    assert store.version == (v0[0] + 2, v0[1], v0[2])
    assert store.graph.num_edges == gt.num_edges + 4 - 1, "one trimmed"
    e = store.graph.num_edges
    assert not np.all(np.diff(store.graph.src.numpy()[:e]) >= 0), \
        "the streamed edge arrays are no longer src-sorted"


def test_clean_slots_are_not_resampled(graphs):
    _, gt = graphs
    store = _tstore(gt, frontier="sparse", batches=8)
    tracker = tstream.DirtySlotTracker.for_store(store)
    delta = tstream.random_delta(store.graph, np.random.default_rng(31),
                                 num_deletes=2, num_inserts=0,
                                 dst_rows=np.arange(64))
    before = list(store.batches)
    plan = tstream.plan_refresh(store, tracker, delta)
    tstream.apply_plan(store, plan)
    assert plan.dirty_slots, "a live-edge delete must dirty someone"
    for i, b in enumerate(before):
        if i not in plan.dirty_slots:
            assert store.batches[i] is b, \
                "clean slots must keep their batch object (no resample)"
    _assert_equals_cold(store)


# ------------------------------------- values-only frontier-index patch
@pytest.mark.parametrize("diffusion", ["ic", "lt"])
def test_patch_frontier_index_matches_fresh_build(graphs, diffusion):
    gj, gt = graphs
    g_rev0 = tcsr.transpose(gt)
    if diffusion == "lt":
        g_rev0 = tlt.normalize_lt_weights(g_rev0)

    def cb(g):
        return tlt.selection_cum_before(g) if diffusion == "lt" else None

    fidx = tsparse.build_frontier_index(g_rev0, tile_rows=64, cb=cb(g_rev0))
    delta = tstream.random_delta(gt, np.random.default_rng(71),
                                 num_deletes=6, num_inserts=0)
    g_rev2, applied = tstream.apply_delta(g_rev0, delta.reversed(),
                                          lt_normalized=diffusion == "lt")
    blocks = tstream.touched_row_blocks(applied.touched_rows, 64)
    assert len(blocks), "a live-edge delete must touch a row block"
    patched = tsparse.patch_frontier_index(fidx, g_rev2, blocks,
                                           cb=cb(g_rev2))
    assert patched is fidx, "the patch writes the owner's index in place"
    fresh = tsparse.build_frontier_index(g_rev2, tile_rows=64,
                                         cb=cb(g_rev2))
    names = ["blk_src", "blk_dst", "blk_prob", "blk_eid", "blk_valid",
             "blk_rowblock"] + (["blk_cb"] if diffusion == "lt" else [])
    for name in names:
        assert torch.equal(getattr(patched, name), getattr(fresh, name)), \
            name
    assert (patched.num_blocks, patched.edge_block, patched.tile_rows) == \
        (fresh.num_blocks, fresh.edge_block, fresh.tile_rows)
    # The reference's patch on the same delta agrees, less its null block.
    gj_rev2, _ = jstream.apply_delta(jcsr.transpose(gj), jstream.EdgeDelta(
        delta.dst, delta.src, delta.weight, delta.insert))
    if diffusion == "ic":
        jfidx = jsparse.patch_frontier_index(
            jsparse.build_frontier_index(jcsr.transpose(gj), tile_rows=64),
            gj_rev2, blocks)
        np.testing.assert_array_equal(patched.blk_prob.numpy(),
                                      np.asarray(jfidx.blk_prob)[:-1])
    with pytest.raises(ValueError, match="cb must be given"):
        tsparse.patch_frontier_index(fidx, g_rev2, blocks,
                                     cb=None if diffusion == "lt"
                                     else tlt.selection_cum_before(g_rev2))


@pytest.mark.parametrize("diffusion", ["ic", "lt"])
def test_values_only_delta_patches_sampler_in_place(graphs, diffusion):
    _, gt = graphs
    store = _tstore(gt, frontier="sparse", batches=3, diffusion=diffusion)
    s0 = store.sampler
    tracker = tstream.DirtySlotTracker.for_store(store)
    tstream.incremental_refresh(store, tracker, tstream.random_delta(
        store.graph, np.random.default_rng(73), num_deletes=3,
        num_inserts=0))
    assert store.sampler is s0, \
        "a tombstone-only delta must patch the frontier index in place"
    _assert_equals_cold(store)
    (sa, da), = _absent_pairs(store.graph, 1, seed=73)
    tstream.incremental_refresh(store, tracker, tstream.EdgeDelta.inserts(
        [sa], [da], [0.05]))
    assert store.sampler is not s0, \
        "an appending insert changes the edge layout → full rebuild"
    _assert_equals_cold(store)


@pytest.mark.parametrize("backend", ["tiled", "kernel"])
def test_tile_backends_rebuild_their_layout_on_rebind(graphs, backend):
    """The tile samplers rebuild on rebind, on the new pair's own layout:
    the old pair's tiles and slot lists never serve the mutated graph, and
    every sampler over the new pair shares its one layout."""
    _, gt = graphs
    store = _tstore(gt, backend=backend, batches=3)
    clone = store.clone()
    old = store.sampler.tg_rev
    assert clone.sampler.tg_rev is old
    delta = tstream.random_delta(store.graph, np.random.default_rng(5),
                                 num_deletes=3, num_inserts=2)
    tracker = tstream.DirtySlotTracker.for_store(store)
    plan = tstream.plan_refresh(store, tracker, delta)
    for s in (store, clone):
        tstream.apply_plan(s, plan)
    assert store.sampler.tg_rev is not old
    assert clone.sampler.tg_rev is store.sampler.tg_rev
    assert tstream.cold_rebuild_batches  # the cold rebuild shares it too
    cold_sampler = store._make_sampler(store.graph, store.spec, store.g_rev)
    assert cold_sampler.tg_rev is store.sampler.tg_rev
    assert torch.equal(store.visited_stack(), clone.visited_stack())
    _assert_equals_cold(store)


def test_lt_normalised_graphs_are_used_as_they_are():
    """Pinned difference: the reference's sampler normalises whatever it
    is handed, and a second pass moves float32 weights (here 4 of them on
    the launcher's graph); the port uses an already-normalised graph as it
    is, so a store, its clones and its streamed pairs share one graph and
    its stacks.  The masks agree all the same."""
    gj, gt = _pair(300, prob=0.25, seed=7)
    aj = jlt.normalize_lt_weights(jcsr.transpose(gj))
    at = tlt.normalize_lt_weights(tcsr.transpose(gt))
    _assert_same_graph(aj, at)
    moved = np.count_nonzero(np.asarray(jlt.normalize_lt_weights(aj).prob)
                             != np.asarray(aj.prob))
    assert moved == 4
    spec = dict(diffusion="lt", num_colors=64, master_seed=0)
    ts = tmake_sampler(None, TSpec(**spec), g_rev=at)
    assert ts.g_rev is at
    js = jmake_sampler(None, JSpec(**spec), g_rev=aj)
    _assert_same_batches(ts.sample_many(range(8)), js.sample_many(range(8)))
    store = TStore(gt, TPoolConfig(spec=TSpec(backend="kernel", **spec)))
    assert store.clone().sampler.tg_rev is store.sampler.tg_rev


# ------------------------------------------------------------- compaction
def test_compact_graph_drops_tombstones_bit_for_bit(graphs):
    gj, gt = graphs
    delta = tstream.random_delta(gt, np.random.default_rng(81),
                                 num_deletes=8, num_inserts=0)
    g1, _ = tstream.apply_delta(gt, delta)
    assert tstream.tombstone_fraction(gt) == 0.0
    assert tstream.tombstone_fraction(g1) == pytest.approx(8 / g1.num_edges)
    g2, g_rev2 = tstream.compact_graph(g1)
    assert g2.num_edges == g1.num_edges - 8
    assert tstream.tombstone_fraction(g2) == 0.0
    gj1, _ = jstream.apply_delta(gj, jstream.EdgeDelta(
        delta.src, delta.dst, delta.weight, delta.insert))
    gj2, gj_rev2 = jstream.compact_graph(gj1)
    _assert_same_graph(gj2, g2)
    _assert_same_graph(gj_rev2, g_rev2)
    _assert_same_graph(g_rev2, tcsr.transpose(g2))


@pytest.mark.parametrize("backend", BACKENDS)
def test_compact_store_matches_cold_build_on_compacted_graph(graphs,
                                                             backend):
    gj, gt = graphs
    store = _tstore(gt, frontier="sparse", batches=4, backend=backend)
    jstore = _jstore(gj, frontier="sparse", batches=4)
    delta = tstream.random_delta(store.graph, np.random.default_rng(83),
                                 num_deletes=6, num_inserts=2)
    tstream.incremental_refresh(
        store, tstream.DirtySlotTracker.for_store(store), delta)
    jstream.incremental_refresh(
        jstore, jstream.DirtySlotTracker.for_store(jstore),
        jstream.EdgeDelta(delta.src, delta.dst, delta.weight, delta.insert))
    frac = tstream.tombstone_fraction(store.graph)
    assert frac > 0
    assert tstream.compact_store(store) == pytest.approx(frac)
    jstream.compact_store(jstore)
    assert tstream.tombstone_fraction(store.graph) == 0.0
    _assert_equals_cold(store)
    _assert_same_batches(store.batches, jstore.batches,
                         visits=backend == "dense")


def test_tier_maybe_compact_policy_and_counter(graphs):
    _, gt = graphs
    store = _tstore(gt, frontier="sparse", batches=3)
    with ServingTier.build(store, replicas=2, quota_qps=None,
                           default_deadline=0.05) as tier:
        tier.apply_delta("ops", tstream.random_delta(
            store.graph, np.random.default_rng(91), num_deletes=5,
            num_inserts=0))
        r0 = tier.group.replicas[0].store
        assert tstream.tombstone_fraction(r0.graph) > 0
        assert not tier.maybe_compact(threshold=0.5)
        assert tier.maybe_compact(threshold=0.0)
        assert tstream.tombstone_fraction(r0.graph) == 0.0
        assert not tier.maybe_compact(threshold=0.0)
        assert tier.group.consistent()
        assert torch.equal(r0.visited_stack(),
                           tier.group.replicas[1].store.visited_stack())
        _assert_equals_cold(r0)
        snap = tier.snapshot()
        assert snap["stream"]["compactions"] == 1
        assert snap["stream"]["compacted_fraction"]["count"] == 1
        tier.gather([tier.submit_sigma("ops", [3, 17, 29])])


# ------------------------------------------------- version + persistence
def test_graph_epoch_in_version_clone_and_snapshot(graphs, tmp_path):
    gj, gt = graphs
    store = _tstore(gt, batches=3)
    tstream.incremental_refresh(
        store, tstream.DirtySlotTracker.for_store(store),
        tstream.random_delta(store.graph, np.random.default_rng(41),
                             num_deletes=2, num_inserts=2))
    assert store.version[0] == 1
    assert store.clone().version == store.version
    store.save(str(tmp_path))
    back = TStore.restore(str(tmp_path), store.graph, store.config,
                          g_rev=store.g_rev)
    assert back.version == store.version
    assert torch.equal(back.visited_stack(), store.visited_stack())
    # The reference reads the streamed snapshot too.
    jback = JStore.restore(str(tmp_path), gj, JPoolConfig(
        spec=JSpec(**_spec_kw())))
    assert jback.version == store.version


# ------------------------------------------------------------------ tier
@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_tier_apply_delta_end_to_end(graphs, backend):
    gj, gt = graphs
    store = _tstore(gt, frontier="sparse", batches=4, backend=backend)
    jstore = _jstore(gj, frontier="sparse", batches=4)
    with ServingTier.build(store, replicas=2, quota_qps=None,
                           default_deadline=0.05) as tier:
        pre = [tier.submit_sigma("ops", [3, 17, 29])]
        tier.gather(pre)
        delta = tstream.random_delta(store.graph, np.random.default_rng(51),
                                     num_deletes=3, num_inserts=3)
        report = tier.apply_delta("ops", delta)
        assert report.inserted == 3 and report.deleted == 3
        assert report.rebind_s >= 0 and report.resample_s >= 0
        versions = {r.version for r in tier.group.replicas}
        assert len(versions) == 1 and next(iter(versions))[0] == 1
        r0 = tier.group.replicas[0].store
        _assert_equals_cold(r0)
        jstream.incremental_refresh(
            jstore, jstream.DirtySlotTracker.for_store(jstore),
            jstream.EdgeDelta(delta.src, delta.dst, delta.weight,
                              delta.insert))
        _assert_same_batches(r0.batches, jstore.batches,
                             visits=backend == "dense")
        post = [tier.submit_sigma("ops", [3, 17, 29])]
        with pytest.raises(EpochMixError):
            tier.gather(pre + post)
        tier.gather(post)

        tier.set_quota("vandal", rate=0.01, burst=1)
        tier.apply_delta("vandal", tstream.EdgeDelta.deletes([], []))
        with pytest.raises(ShedError):
            tier.apply_delta("vandal", tstream.EdgeDelta.deletes([], []))
        snap = tier.snapshot()
        assert snap["stream"]["deltas_applied"] == 2
        assert snap["stream"]["tracker"]["slots"] == 4
        assert snap["stream"]["tracker"]["deltas_seen"] == 2
        assert snap["stream"]["refresh_s"]["count"] == 2
