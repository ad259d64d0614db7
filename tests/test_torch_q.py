"""Port ≡ reference for the quantised-tile traversal.

On CPU tensors `repro_torch.kernels.ops.fused_expand_q` runs the kernel's
plain version (`kernels.ref.fused_expand_q_ref`); here it is held against
the reference's Pallas kernels in interpret mode
(``repro.kernels.fused_expand_q``, as the reference's own tests run them)
and against their oracle ``fused_expand_q_ref``.  Tolerances: exact
(integer words, uint8 thresholds, level counts) unless a test says
otherwise.  The CUDA kernel is held against the same plain version on the
GPU (`tests/test_torch_cuda.py`, ``chip_smoke.py``)."""
import dataclasses
import functools
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmask as jbitmask
from repro.core import rrr as jrrr
from repro.core import sparse as jsparse
from repro.core import tiles as jtiles
from repro.core import traversal as jtr
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.graph import reorder as jreorder
from repro.kernels import fused_expand_q as feq
from repro_torch import convert
from repro_torch.core import bitmask, rrr, tiled_traversal, tiles, traversal
from repro_torch.graph import csr, generators, reorder
from repro_torch.kernels import fused_expand_q as tfq
from repro_torch.kernels import ops, ref

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.json")


def _random_graph(n, e, p, seed):
    """The reference kernel tests' graph (``tests/test_kernels.py``):
    (reference graph, port graph) with the same CSR arrays."""
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n, e)
    dst = (src + 1 + rs.integers(0, n - 1, e)) % n
    probs = (rs.uniform(*p, e) if isinstance(p, tuple)
             else np.full(e, p)).astype(np.float32)
    gj = jcsr.from_edges(src, dst, probs, n, dedupe=True)
    gt = convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), n, gj.num_edges, device="cpu")
    return gj, gt


def _masks(vp, colors, seed, density):
    """(frontier, visited ⊇ frontier) uint32 masks with random bits."""
    rs = np.random.default_rng(seed)
    w = -(-colors // 32)
    tail = np.full(w, 0xFFFFFFFF, np.uint32)
    if colors % 32:
        tail[-1] = (1 << (colors % 32)) - 1

    def bits(p):
        lanes = rs.random((vp, w, 32)) < p
        return (np.packbits(lanes, axis=-1, bitorder="little")
                .view(np.uint32)[..., 0] & tail)

    fr = bits(density)
    return fr, fr | bits(0.2)


def _t(words):
    return convert.masks_from_numpy(words, "cpu")


# ------------------------------------------------------------ quantisation
def _prob_sets():
    k = np.arange(257, dtype=np.float32) / np.float32(256)
    rs = np.random.default_rng(0)
    return {
        "random": rs.random(4096, dtype=np.float32),
        "endpoints": np.asarray([0.0, 1.0, 1e-9, 0.5, -0.25, 1.5, 2 ** -9,
                                 np.float32(1) - np.float32(2 ** -24)],
                                np.float32),
        "k/256": k,
        "k/256 ± 1 ulp": np.concatenate(
            [np.nextafter(k, np.float32(2)), np.nextafter(k, np.float32(-1))]),
        "(k+1/2)/256 (ties)": (np.arange(256, dtype=np.float32)
                               + np.float32(0.5)) / np.float32(256),
    }


@pytest.mark.parametrize("which", list(_prob_sets()))
def test_quantize_probs_matches_reference(which):
    """Exact: rounding half to even in both, p ≤ 0 → 0, p = 1 → 255."""
    p = _prob_sets()[which]
    got = tfq.quantize_probs(torch.from_numpy(p)).numpy()
    want = np.asarray(feq.quantize_probs(jnp.asarray(p)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _cells(kind):
    """uint32 cell ids: just below 2³² − 16,384·k, or those of slots of
    tiles with ids ≥ 262,144 (which wrap at T = 128), as the reference
    computes them in uint32."""
    if kind == "near 2^32 - 16384k":
        k = np.arange(0, 9, dtype=np.int64)
        c = (2 ** 32 - 16384 * k)[:, None] + np.arange(-3, 3)[None, :]
        return (c.ravel() % 2 ** 32).astype(np.uint32)
    rs = np.random.default_rng(1)
    tile = rs.integers(262_144, 600_000, 64)
    i, j = rs.integers(0, 128, 64), rs.integers(0, 128, 64)
    want = np.asarray(jnp.asarray(tile).astype(jnp.uint32) * jnp.uint32(
        128 * 128) + jnp.asarray(i, jnp.uint32) * jnp.uint32(128)
        + jnp.asarray(j, jnp.uint32))
    got = ref.q_cell_ids(torch.from_numpy(tile), torch.from_numpy(i),
                         torch.from_numpy(j), 128).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    return want


@pytest.mark.parametrize("kind", ["near 2^32 - 16384k", "tile ids ≥ 2^18"])
@pytest.mark.parametrize("word", [0, 1, 7])
def test_bern_word_q_matches_reference(kind, word):
    """Exact: the 32 lanes of one word, over q from 0 to 255."""
    cells = _cells(kind)
    q8 = np.random.default_rng(2).integers(0, 256, cells.shape,
                                           dtype=np.uint8)
    q8[:4] = [0, 1, 254, 255]
    for seed, level in ((3, 0), (0xDEADBEEF, 17)):
        want = np.asarray(feq._bern_word_q(
            jnp.uint32(seed), jnp.uint32(level), jnp.asarray(cells),
            jnp.uint32(word), jnp.asarray(q8)))
        got = ref._bern_word_q(seed, level,
                               torch.from_numpy(cells.astype(np.int64)),
                               word, torch.from_numpy(q8))
        np.testing.assert_array_equal(convert.masks_to_numpy(got), want)


# -------------------------------------------------------------- the layout
@pytest.mark.parametrize("tile_size", [128, 64, 32])
def test_quantized_layout_matches_reference(tile_size):
    """Exact: the tile list and ``quantize_probs(from_graph(g).prob)``."""
    gj, gt = _random_graph(400, 2500, (0.1, 0.9), seed=5)
    tj = jtiles.from_graph(gj, tile_size)
    tg, q8 = tiles.quantized(gt, tile_size)
    assert tg.prob is None and tg.edge_id is None and q8.dtype == torch.uint8
    np.testing.assert_array_equal(q8.numpy(),
                                  np.asarray(feq.quantize_probs(tj.prob)))
    np.testing.assert_array_equal(tg.tile_src.numpy(), np.asarray(tj.tile_src))
    np.testing.assert_array_equal(tg.tile_dst.numpy(), np.asarray(tj.tile_dst))
    assert tg.num_tiles == tj.num_tiles


@pytest.mark.parametrize("pad", [0, 3])
def test_convert_carries_the_reference_q8_layout(pad):
    """Exact: ``convert`` takes the reference's tile list and q8 stack
    (with ``pad_tiles_to`` padding tiles) into the port's layout, whose
    run pointers walk the same runs; one level on it equals the
    reference's oracle."""
    gj, _ = _random_graph(400, 2500, (0.1, 0.9), seed=5)
    nt = jtiles.from_graph(gj).num_tiles
    tj = jtiles.from_graph(gj, pad_tiles_to=nt + pad)
    q8j = feq.quantize_probs(tj.prob)
    tg, q8 = convert.quantized_tiles_from_numpy(
        np.asarray(tj.tile_src), np.asarray(tj.tile_dst), np.asarray(q8j),
        gj.num_vertices, gj.num_edges, device="cpu")
    assert tg.num_tiles == nt + pad
    ptr = tg.dst_run_ptr.numpy()
    first = np.zeros(nt + pad, np.int32)
    first[ptr[:-1][ptr[:-1] < ptr[1:]]] = 1
    np.testing.assert_array_equal(first, np.asarray(tj.first_of_dst))
    fr, vis = _masks(tj.padded_vertices, 64, 4, 0.1)
    want = feq.fused_expand_q_ref(q8j, tj.tile_src, tj.tile_dst,
                                  jnp.asarray(fr), jnp.asarray(vis),
                                  jnp.uint32(5), jnp.uint32(1))
    got = ops.fused_expand_q(tg, q8, _t(fr), _t(vis), 5, 1)
    np.testing.assert_array_equal(convert.masks_to_numpy(got),
                                  np.asarray(want))


def test_float32_kernels_refuse_the_quantised_layout():
    _, gt = _random_graph(300, 1500, 0.5, seed=1)
    tg, q8 = tiles.quantized(gt)
    fr = torch.zeros((tg.padded_vertices, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="edge id"):
        ops.fused_expand(tg, fr, fr, 0, 0)
    u = torch.zeros((tg.padded_vertices, 32))
    with pytest.raises(ValueError, match="quantised layout"):
        ops.lt_select_expand(tg, q8, fr, fr, u)
    with pytest.raises(ValueError, match="uint8"):
        ops.fused_expand_q(tg, q8.float(), fr, fr, 0, 0)
    slots = tiles.q_slot_list(tg, q8)
    with pytest.raises(ValueError, match="uint8"):
        tfq.fused_expand_q_cuda(
            dataclasses.replace(slots, value=slots.value.float()), fr, fr,
            0, 0)


# ------------------------------------------------------------- one level
@pytest.mark.parametrize("seed,colors,tile_size", [
    (5, 64, 128), (6, 32, 128), (7, 96, 64), (8, 64, 64)])
def test_dense_expand_matches_pallas_and_oracle(seed, colors, tile_size):
    """Exact: the port's dense ``fused_expand_q`` ≡ the Pallas kernel in
    interpret mode ≡ the reference's oracle, with visited ⊋ frontier."""
    gj, gt = _random_graph(400, 2500, (0.1, 0.9), seed=seed)
    tj = jtiles.from_graph(gj, tile_size)
    q8j = feq.quantize_probs(tj.prob)
    fr, vis = _masks(tj.padded_vertices, colors, seed, 0.05)
    args = (jnp.asarray(fr), jnp.asarray(vis), jnp.uint32(3),
            jnp.uint32(2))
    pallas = np.asarray(feq.fused_expand_q(
        q8j, tj.tile_src, tj.tile_dst, tj.first_of_dst, *args,
        interpret=True))
    oracle = np.asarray(feq.fused_expand_q_ref(q8j, tj.tile_src,
                                               tj.tile_dst, *args))
    np.testing.assert_array_equal(pallas, oracle)
    tg, q8 = tiles.quantized(gt, tile_size)
    before = dict(ops.LAUNCHES)
    got = ops.fused_expand_q(tg, q8, _t(fr), _t(vis), 3, 2)
    assert ops.LAUNCHES == before          # plain version on CPU: no launch
    assert pallas.any()
    np.testing.assert_array_equal(convert.masks_to_numpy(got), pallas)


@pytest.mark.parametrize("roots", ["one vertex", "two blocks"])
def test_list_mode_matches_gathered_pallas(roots):
    """Exact: the port's list mode on the full stack ≡ the reference's
    ``fused_expand_q_gathered`` on its null-padded gathered list (capacity
    n_active + 3, as ``tests/test_kernels.py`` builds it) ≡ the dense
    grid: the null tile contributes nothing, so the exact-length list
    gives the same words."""
    gj, gt = _random_graph(400, 2500, (0.1, 0.9), seed=6)
    tj = jtiles.from_graph(gj)
    q8j = feq.quantize_probs(tj.prob)
    starts = (jnp.zeros((64,), jnp.int32) if roots == "one vertex"
              else jnp.asarray(np.repeat([3, 300], 32), jnp.int32))
    fr = jtiles.pad_mask_rows(jtr.init_frontier(gj.num_vertices, 64, starts),
                              tj.padded_vertices)
    dense = feq.fused_expand_q(q8j, tj.tile_src, tj.tile_dst,
                               tj.first_of_dst, fr, fr, jnp.uint32(3),
                               jnp.uint32(0), interpret=True)
    tgn = jtiles.with_null_tile(tj)
    q8n = feq.quantize_probs(tgn.prob)
    act = jsparse.row_block_activity(fr, tj.tile_size)
    nt = tj.num_tiles
    n_active = int(np.asarray(act[tj.tile_src].astype(jnp.int32)).sum())
    assert 0 < n_active < nt                    # genuinely compacted
    ids = jtiles.active_tile_ids(tj.tile_src, act, n_active + 3, nt)
    fi = jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         (tgn.tile_dst[ids][1:] != tgn.tile_dst[ids][:-1]).astype(jnp.int32)])
    gathered = np.asarray(feq.fused_expand_q_gathered(
        q8n[ids], ids, tgn.tile_src[ids], tgn.tile_dst[ids], fi, fr, fr,
        jnp.uint32(3), jnp.uint32(0), interpret=True))
    np.testing.assert_array_equal(gathered, np.asarray(dense))

    tg, q8 = tiles.quantized(gt)
    frt = _t(np.asarray(fr))
    port_ids = tiles.active_tile_ids(
        tg.tile_src, torch.from_numpy(np.array(act)))
    assert port_ids.numel() == n_active
    np.testing.assert_array_equal(port_ids.numpy(),
                                  np.asarray(ids)[:n_active])
    got = ops.fused_expand_q(tg, q8, frt, frt, 3, 0, tile_ids=port_ids)
    np.testing.assert_array_equal(convert.masks_to_numpy(got), gathered)


# ------------------------------------------------------------ traversals
_expand_q_ref = jax.jit(feq.fused_expand_q_ref)


def _graph_q_loop(q8, tile_src, tile_dst, num_vertices, padded, starts,
                  colors, seed, max_levels=64):
    """The reference's ``graph_q`` level loop (``launch/dryrun.py:260-281``)
    at one shard, composed from ``fused_expand_q_ref``; returns (visited
    (V, W) uint32, levels)."""
    fr = jtiles.pad_mask_rows(
        jtr.init_frontier(num_vertices, colors, jnp.asarray(starts)), padded)
    vis = jnp.zeros_like(fr)
    level = 0
    while level < max_levels and bool(jbitmask.any_set(fr)):
        vis = vis | fr
        fr = _expand_q_ref(q8, tile_src, tile_dst, fr, vis, jnp.uint32(seed),
                           jnp.uint32(level))
        level += 1
    return np.asarray(vis | fr)[:num_vertices], level


def _slice_graphs(n, seed, prob=0.25):
    """The slice's graph at a small size: (port graph, reference tiles and
    q8 stack) — powerlaw_cluster, deduped, ``cluster`` order, reversed, in
    both packages."""
    gj = jcsr.transpose(jreorder.apply(jcsr.dedupe(jgen.powerlaw_cluster(
        n, 6.0, prob=prob, seed=seed)), "cluster")[0])
    gt = csr.transpose(reorder.apply(csr.dedupe(generators.powerlaw_cluster(
        n, 6.0, prob=prob, seed=seed, device="cpu")), "cluster")[0])
    tj = jtiles.from_graph(gj)
    return gt, tj, feq.quantize_probs(tj.prob)


@functools.lru_cache(maxsize=None)
def _slice_reference(batch):
    """(port graph, reference q8 tiles, reference visited, levels) of one
    batch of the slice at n = 600 (master seed 0, 64 colours)."""
    gt, tj, q8j = _slice_graphs(600, 7)
    starts = jrrr.batch_starts(600, 64, 0, batch)
    seed = int(jrrr.batch_seeds(0, [batch])[0])
    want, levels = _graph_q_loop(q8j, tj.tile_src, tj.tile_dst, 600,
                                 tj.padded_vertices, starts, 64, seed)
    return gt, np.asarray(q8j), want, levels, seed


@pytest.mark.parametrize("frontier", ["dense", "sparse"])
@pytest.mark.parametrize("batch", [0, 1])
def test_q_traversal_matches_graph_q_loop(frontier, batch):
    """Exact, levels and words: the whole slice at n = 600 — generator,
    ``cluster`` reordering, q8 layout and ``run_fused_q_tiled`` — ≡ the
    reference's ``graph_q`` loop on its own q8 tiles, with the batch's
    roots and seed (``rrr.batch_starts``/``batch_seeds``, master seed 0)."""
    gt, q8j, want, levels, seed = _slice_reference(batch)
    tg, q8 = tiles.quantized(gt)
    np.testing.assert_array_equal(q8.numpy(), q8j)
    work = {}
    vis, got_levels, steps = tiled_traversal.run_fused_q_tiled(
        tg, q8, rrr.batch_starts(600, 64, 0, batch), 64, seed,
        frontier=frontier, work=work)
    assert got_levels == levels > 1
    assert len(work["active_tiles"]) == levels
    if frontier == "dense":
        assert steps == levels * tg.num_tiles
    np.testing.assert_array_equal(convert.masks_to_numpy(vis), want)


@pytest.mark.parametrize("frontier", ["dense", "sparse"])
def test_q_traversal_at_p1_is_the_csr_bfs(frontier):
    """Exact: at p = 1 (q = 255) every edge crosses, so the quantised
    traversal is the deterministic BFS of the CSR sweep ``run_fused``
    (the reference's ``test_fused_expand_q_p1_full_bfs``, run to the
    end)."""
    _, gt = _random_graph(300, 1500, 1.0, seed=2)
    src, dst, _ = gt.edges_numpy()     # dedupe leaves single edges at 1 - 1e-7
    g_rev = csr.transpose(csr.from_edges(src, dst, np.ones(len(src)), 300,
                                         device="cpu"))
    tg, q8 = tiles.quantized(g_rev)
    assert bool((q8[q8 > 0] == 255).all())
    starts = traversal.random_starts(1, 300, 32)
    vis, levels, _ = tiled_traversal.run_fused_q_tiled(
        tg, q8, starts, 32, 0, frontier=frontier)
    want = traversal.run_fused(g_rev, starts, 32, 0)
    assert levels == want.stats.levels_run
    assert torch.equal(vis, want.visited)


def test_q_statistics_match_the_exact_path():
    """Within 5%: one level's reached (vertex, colour) count summed over 5
    seeds, quantised against the float32 tile path on the same frontier
    (the reference's ``test_fused_expand_q_statistics_match_exact_path``;
    the draws differ, the probabilities agree to 1/256)."""
    gj, gt = _random_graph(600, 6000, 0.4, seed=8)
    tf = tiles.from_graph(gt)
    tg, q8 = tiles.quantized(gt)
    starts = traversal.random_starts(2, 600, 128)
    fr = tiles.pad_mask_rows(traversal.init_frontier(600, 128, starts, "cpu"),
                             tg.padded_vertices)
    a = b = 0
    for seed in range(5):
        a += int(bitmask.count_colors(
            ops.fused_expand_q(tg, q8, fr, fr, seed, 0)).sum())
        b += int(bitmask.count_colors(
            ops.fused_expand(tf, fr, fr, seed, 0)).sum())
    assert abs(a - b) / max(b, 1) < 0.05, (a, b)


def _sha(words) -> str:
    return hashlib.sha256(np.ascontiguousarray(words, "<u4").tobytes()) \
        .hexdigest()


@pytest.mark.parametrize("frontier", ["dense", "sparse"])
def test_port_matches_golden_q_entry(frontier):
    """Exact: the port's slice at the golden file's ``"q"`` size, on the
    CPU, reproduces what ``scripts/make_torch_golden.py`` recorded from the
    reference (levels, popcount and sha256 per batch) — the values
    ``chip_smoke.py`` holds the card to."""
    with open(GOLDEN) as f:
        gold = json.load(f)["q"]
    spec = gold["graph"]
    g = csr.transpose(reorder.apply(csr.dedupe(generators.powerlaw_cluster(
        spec["n"], spec["avg_deg"], prob=spec["prob"], seed=spec["seed"],
        device="cpu")), spec["order"])[0])
    tg, q8 = tiles.quantized(g)
    assert (g.num_edges, tg.num_tiles) == (spec["num_edges"],
                                           spec["num_tiles"])
    for gb in gold["batches"]:
        b = gb["batch_index"]
        vis, levels, _ = tiled_traversal.run_fused_q_tiled(
            tg, q8, rrr.batch_starts(spec["n"], gold["num_colors"],
                                     gold["master_seed"], b),
            gold["num_colors"], rrr.batch_seed(gold["master_seed"], b),
            frontier=frontier)
        words = convert.masks_to_numpy(vis)
        assert levels == gb["levels"]
        assert int(np.unpackbits(words.view(np.uint8)).sum()) == \
            gb["visited_bits"]
        assert _sha(words) == gb["visited_sha256"]
