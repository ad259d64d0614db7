"""CUDA kernels of the port ≡ their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels build from
``src/repro_torch/csrc`` at first use) and skips elsewhere.  Run them on a
GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import lt, rrr, tiled_traversal, tiles
from repro_torch.graph import csr, generators
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.fused_expand_q import quantize_probs
from repro_torch.sampling import SamplerSpec, make_sampler

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _tiled(n, e, *, seed, tile_size, dst_limit=None, pad=0):
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n, e)
    dst = rs.integers(0, dst_limit or n, e)
    keep = src != dst
    g = csr.from_edges(src[keep], dst[keep],
                       rs.uniform(0, 1, keep.sum()).astype(np.float32), n,
                       dedupe=True, device="cuda")
    nt = tiles.from_graph(g, tile_size).num_tiles
    return tiles.from_graph(g, tile_size, pad_tiles_to=nt + pad)


def _masks(vp, colors, seed, density, device):
    rs = np.random.default_rng(seed)
    w = -(-colors // 32)
    lanes = rs.random((2, vp, w, 32)) < [[[[density]]], [[[0.2]]]]
    words = np.packbits(lanes, axis=-1, bitorder="little") \
        .view(np.uint32)[..., 0]
    if colors % 32:
        words[..., -1] &= (1 << (colors % 32)) - 1
    fr = convert.masks_from_numpy(words[0], device)
    return fr, fr | convert.masks_from_numpy(words[1], device)


@pytest.mark.parametrize("tile_size", [32, 64, 128])
@pytest.mark.parametrize("colors", [32, 64, 96])
def test_fused_expand_kernel_equals_plain(cuda, tile_size, colors):
    tg = _tiled(3000, 20000, seed=colors, tile_size=tile_size,
                dst_limit=2200, pad=3)
    for density in (0.0, 0.05, 0.5):
        fr, vis = _masks(tg.padded_vertices, colors, colors, density, cuda)
        before = ops.LAUNCHES["fused_expand"]
        got = ops.fused_expand(tg, fr, vis, 0xC0FFEE, 7)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fused_expand"] == before + 1
        want = ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                    tg.tile_dst, fr, vis, 0xC0FFEE, 7)
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,v,w", [(1, 300, 2), (64, 4096, 2), (5, 1000, 3)])
def test_cover_counts_kernel_equals_plain(cuda, b, v, w):
    g = torch.Generator(device="cuda").manual_seed(b)
    vis = torch.randint(-2 ** 31, 2 ** 31, (b, v, w), dtype=torch.int32,
                        device=cuda, generator=g)
    act = torch.randint(-2 ** 31, 2 ** 31, (b, w), dtype=torch.int32,
                        device=cuda, generator=g)
    before = ops.LAUNCHES["cover_counts"]
    got = ops.cover_counts(vis, act)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cover_counts"] == before + 1
    assert torch.equal(got, ref.cover_counts_ref(vis, act))


def test_kernel_traversal_equals_csr_sweep(cuda):
    g = csr.dedupe(generators.powerlaw_cluster(5000, 6.0, prob=0.25, seed=7,
                                               device="cuda"))
    g_rev = csr.transpose(g)
    tg = tiles.from_graph(g_rev)
    for b in range(2):
        starts = rrr.batch_starts(5000, 64, 0, b)
        vis, levels, _ = tiled_traversal.run_fused_tiled(
            tg, starts, 64, rrr.batch_seed(0, b))
        dense = rrr.sample_batch(g_rev, 64, 0, b)
        assert levels > 0 and torch.equal(vis, dense.visited)


def _lt_tiled(n, e, *, seed, tile_size, dst_limit=None, pad=0):
    """(tiles, cb tiles) of an LT-normalised random graph on the GPU."""
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n, e)
    dst = rs.integers(0, dst_limit or n, e)
    keep = src != dst
    g = lt.normalize_lt_weights(csr.from_edges(
        src[keep], dst[keep], rs.uniform(0, 1, keep.sum()).astype(np.float32),
        n, dedupe=True, device="cuda"))
    nt = tiles.from_graph(g, tile_size).num_tiles
    tg = tiles.from_graph(g, tile_size, pad_tiles_to=nt + pad)
    return tg, tiles.lt_cb_tiles(tg, g, lt.selection_cum_before(g))


@pytest.mark.parametrize("tile_size", [32, 64, 128])
@pytest.mark.parametrize("colors", [32, 64, 96])
def test_lt_select_expand_kernel_equals_plain(cuda, tile_size, colors):
    """Empty, sparse and dense frontiers; destination blocks no tile
    reaches; padding tiles."""
    tg, cb = _lt_tiled(3000, 20000, seed=colors, tile_size=tile_size,
                       dst_limit=2200, pad=3)
    u = ref.lt_selection_uniforms(0xC0FFEE, tg.padded_vertices, colors,
                                  device=cuda)
    for density in (0.0, 0.05, 0.5):
        fr, vis = _masks(tg.padded_vertices, colors, colors, density, cuda)
        before = ops.LAUNCHES["lt_select_expand"]
        got = ops.lt_select_expand(tg, cb, fr, vis, u)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["lt_select_expand"] == before + 1
        want = ref.lt_select_expand_ref(tg.prob, cb, tg.tile_src,
                                        tg.tile_dst, fr, vis, u)
        assert torch.equal(got, want)
        assert bool(got.any()) == (density > 0)


@pytest.mark.parametrize("tile_size", [32, 128])
@pytest.mark.parametrize("active", ["none", "one", "all"])
def test_tile_kernels_on_compacted_lists_equal_plain(cuda, tile_size,
                                                     active):
    """Both tile kernels walking a compacted tile list ≡ their plain
    versions on the gathered tiles: an empty list, one source block, the
    full list."""
    tg, cb = _lt_tiled(3000, 20000, seed=tile_size, tile_size=tile_size,
                       dst_limit=2200, pad=2)
    fr, vis = _masks(tg.padded_vertices, 64, 1, 0.3, cuda)
    act = torch.zeros(tg.num_blocks, dtype=torch.bool, device=cuda)
    if active == "one":
        act[3] = True
    elif active == "all":
        act[:] = True
    fr = fr * act.repeat_interleave(tile_size)[:, None]
    ids = tiles.active_tile_ids(tg.tile_src, act)
    assert (ids.numel() == 0) == (active == "none")
    u = ref.lt_selection_uniforms(7, tg.padded_vertices, 64, device=cuda)
    sel = ids.long()
    got = ops.fused_expand(tg, fr, vis, 11, 3, tile_ids=ids)
    want = ref.fused_expand_ref(tg.prob[sel], tg.edge_id[sel],
                                tg.tile_src[sel], tg.tile_dst[sel], fr, vis,
                                11, 3)
    assert torch.equal(got, want)
    got = ops.lt_select_expand(tg, cb, fr, vis, u, tile_ids=ids)
    want = ref.lt_select_expand_ref(tg.prob[sel], cb[sel], tg.tile_src[sel],
                                    tg.tile_dst[sel], fr, vis, u)
    assert torch.equal(got, want)
    if active == "all":       # the full list ≡ the dense grid
        assert torch.equal(got, ops.lt_select_expand(tg, cb, fr, vis, u))


@pytest.mark.parametrize("diffusion", ["ic", "lt"])
def test_sparse_kernel_sampler_equals_dense_csr(cuda, diffusion):
    g = csr.dedupe(generators.powerlaw_cluster(5000, 6.0, prob=0.25, seed=7,
                                               device="cuda"))
    spec = SamplerSpec(diffusion=diffusion, backend="kernel",
                       frontier="sparse")
    kern = make_sampler(g, spec)
    dense = make_sampler(g, SamplerSpec(diffusion=diffusion))
    for b in range(2):
        got = kern.sample(b)
        assert kern.last_active_tiles <= kern.last_grid_steps
        assert torch.equal(got.visited, dense.sample(b).visited)


def _qkv(b, lq, lk, h, kvh, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((b, lq, h, d), generator=g, device="cuda").to(dtype),
            torch.randn((b, lk, kvh, d), generator=g, device="cuda").to(dtype),
            torch.randn((b, lk, kvh, d), generator=g, device="cuda").to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,lq,lk,h,kvh,d,kv_offset", [
    (1, 128, 128, 2, 2, 64, 0), (2, 100, 100, 6, 2, 96, 0),
    (2, 1, 77, 8, 1, 128, 40), (3, 1, 2080, 24, 8, 128, 2079),
    (1, 65, 130, 3, 3, 192, 65), (1, 33, 33, 4, 4, 16, 0),
    (1, 64, 64, 2, 1, 256, 0)])
def test_flash_attention_kernel_equals_plain(cuda, dtype, causal, b, lq, lk,
                                             h, kvh, d, kv_offset):
    """Ragged lengths, grouped heads (H/KVH 1, 3, 8), head dims 16-256,
    decode (Lq 1 at kv_offset) and not; f32 within 2e-5, bf16 within the
    reference's 2e-2 (compared in float32)."""
    q, k, v = _qkv(b, lq, lk, h, kvh, d, dtype, lq * 7 + d)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, kv_offset=kv_offset)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   kv_offset=kv_offset)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("route,dtype,b,lq,lk,h,kvh,d,causal,kv_offset", [
    ("wgmma", torch.bfloat16, 1, 512, 512, 24, 8, 128, True, 0),
    ("wgmma", torch.bfloat16, 2, 32, 32, 8, 8, 128, True, 0),
    ("wgmma", torch.bfloat16, 2, 257, 300, 6, 2, 64, True, 17),
    ("wgmma", torch.bfloat16, 2, 257, 300, 6, 2, 64, False, 0),
    ("decode", torch.float32, 3, 1, 2080, 24, 8, 128, True, 2079),
    ("decode", torch.bfloat16, 3, 1, 2080, 24, 8, 128, True, 1000),
    ("decode", torch.float32, 2, 1, 300, 12, 1, 96, True, 150),
    ("decode", torch.bfloat16, 1, 1, 77, 8, 8, 16, True, 0),
    ("decode", torch.float32, 1, 1, 64, 4, 2, 256, False, 0),
    ("tf32x3", torch.float32, 1, 130, 190, 8, 1, 128, True, 60),
    ("wgmma", torch.bfloat16, 2, 100, 100, 6, 2, 96, True, 0),
    ("wgmma", torch.bfloat16, 2, 130, 130, 8, 8, 80, True, 0),
    ("wgmma", torch.bfloat16, 1, 130, 190, 8, 1, 96, False, 60),
    ("wgmma", torch.bfloat16, 2, 257, 457, 6, 2, 80, True, 17),
    ("tf32x3", torch.float32, 2, 100, 100, 6, 2, 96, True, 0),
    ("tf32x3", torch.float32, 2, 130, 130, 8, 8, 80, True, 0),
    ("wgmma", torch.bfloat16, 1, 65, 129, 6, 2, 192, True, 64),
    ("tf32x3", torch.float32, 1, 65, 129, 6, 2, 192, True, 64),
    ("simt", torch.float32, 2, 100, 140, 4, 4, 32, True, 40),
    ("decode", torch.bfloat16, 2, 1, 300, 8, 8, 80, True, 299)])
def test_flash_route_kernel_equals_plain(cuda, route, dtype, b, lq, lk, h,
                                         kvh, d, causal, kv_offset):
    """Each route on shapes it takes (ragged Lq and Lk, Lq below one query
    block, GQA groups 1 to 12, kv_offset 0 to Lk - 1): the route's own
    counter moves by one and the output is the plain version's, f32
    within 2e-5, bf16 within 2e-2."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.route(dtype, b, lq, lk, h, kvh, d, causal) == route
    q, k, v = _qkv(b, lq, lk, h, kvh, d, dtype, lk * 3 + d)
    before = ops.LAUNCHES[f"flash_{route}"]
    got = ops.flash_attention(q, k, v, causal=causal, kv_offset=kv_offset)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[f"flash_{route}"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   kv_offset=kv_offset)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lk,kv_offset", [
    (2, 77, 30), (2, 77, 0), (4, 2080, 2079), (1, 300, 299)])
def test_decode_route_equals_splitk_plain_at_its_split(cuda, dtype, b, lk,
                                                       kv_offset):
    """The decode kernel against the split-K plain version cut at the
    kernel's own split (`decode_split` over the visible keys)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(b, 1, lk, 24, 8, 128, dtype, lk + kv_offset)
    got = fa.flash_decode_cuda(q, k, v, causal=True, scale=128 ** -0.5,
                               kv_offset=kv_offset)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_vis = fa.visible_keys(lk, True, kv_offset)
    chunk, _ = fa.decode_split(b, 8, 24, n_vis, sms)
    want = ref.flash_decode_splitk_ref(q, k, v, chunk=chunk, causal=True,
                                       kv_offset=kv_offset)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_decode_route_on_two_streams_at_once(cuda):
    """Decode launches queued on two streams at once, each stream on
    inputs of its own, all give the plain version: every launch merges
    through arrival counters of its own."""
    from repro_torch.kernels import flash_attention as fa
    ins = [_qkv(4, 1, 2080, 24, 8, 128, torch.bfloat16, seed)
           for seed in (11, 12)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for (q, k, v), stream, got in zip(ins, streams, outs):
            with torch.cuda.stream(stream):
                got.append(fa.flash_decode_cuda(
                    q, k, v, causal=True, scale=128 ** -0.5,
                    kv_offset=2079))
    torch.cuda.synchronize()
    for (q, k, v), got in zip(ins, outs):
        want = ref.flash_attention_ref(q, k, v, causal=True, kv_offset=2079)
        for o in got:
            torch.testing.assert_close(o.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)


@pytest.mark.parametrize("route", ["wgmma", "decode"])
def test_flash_routes_replay_from_a_cuda_graph(cuda, route):
    """A graph of three launches replayed twice gives the plain version
    each time: the wgmma route's tensor maps travel by value in the
    launch, and the decode route zeroes its arrival counters in each."""
    from repro_torch.kernels import flash_attention as fa
    lq, off = (300, 0) if route == "wgmma" else (1, 500)
    q, k, v = _qkv(2, lq, 600, 12, 4, 128, torch.bfloat16, 7)
    fn = fa.CUDA_ROUTES[route]
    outs = []

    def step():
        outs.append(fn(q, k, v, causal=True, scale=128 ** -0.5,
                       kv_offset=off))

    step()
    torch.cuda.synchronize()
    outs.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(3):
            step()
    want = ref.flash_attention_ref(q, k, v, causal=True, kv_offset=off)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o in outs:
            torch.testing.assert_close(o.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)


def _q_tiled(n, e, *, seed, tile_size, dst_limit=None, pad=0):
    """``(tg, q8)`` of a random graph on the GPU, ``pad`` padding tiles
    included: the float32 layout and the reference's ``quantize_probs`` of
    its stack (a third of the edges at p = 1, q = 255)."""
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n, e)
    dst = rs.integers(0, dst_limit or n, e)
    keep = src != dst
    prob = rs.uniform(0, 1, keep.sum()).astype(np.float32)
    prob[::3] = 1.0
    g = csr.from_edges(src[keep], dst[keep], prob, n, dedupe=True,
                       device="cuda")
    nt = tiles.from_graph(g, tile_size).num_tiles
    tg = tiles.from_graph(g, tile_size, pad_tiles_to=nt + pad)
    return tg, quantize_probs(tg.prob)


@pytest.mark.parametrize("tile_size", [32, 128])
@pytest.mark.parametrize("colors", [32, 64, 128])
def test_fused_expand_q_kernel_equals_plain(cuda, tile_size, colors):
    """Dense grid and compacted lists (empty, one source block, full);
    empty, sparse and dense frontiers; destination blocks no tile
    reaches; padding tiles."""
    tg, q8 = _q_tiled(3000, 20000, seed=colors, tile_size=tile_size,
                      dst_limit=2200, pad=3)
    for density in (0.0, 0.05, 0.5):
        fr, vis = _masks(tg.padded_vertices, colors, colors, density, cuda)
        act = torch.zeros(tg.num_blocks, dtype=torch.bool, device=cuda)
        lists = [None, tiles.active_tile_ids(tg.tile_src, act)]
        act[int(tg.tile_src[0])] = True
        lists.append(tiles.active_tile_ids(tg.tile_src, act))
        act[:] = True
        lists.append(tiles.active_tile_ids(tg.tile_src, act))
        for ids in lists:
            before = ops.LAUNCHES["fused_expand_q"]
            got = ops.fused_expand_q(tg, q8, fr, vis, 0xC0FFEE, 7,
                                     tile_ids=ids)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["fused_expand_q"] == before + 1
            want = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst, fr,
                                          vis, 0xC0FFEE, 7, tile_ids=ids)
            assert torch.equal(got, want)
            if ids is not None and ids.numel() == 0:
                assert not bool(got.any())


def test_fused_expand_q_kernel_wraps_the_cell_id(cuda):
    """Tile ids past 2¹⁸ at T = 128: the position counter wraps in uint32
    in the kernel as in the plain version (a 4.2 GB stack, mostly zero)."""
    T, nt, live = 128, 262_144 + 2_048, 4_096
    rs = np.random.default_rng(3)
    q8 = torch.zeros((nt, T, T), dtype=torch.uint8, device=cuda)
    first = nt - live
    q8[first:] = torch.from_numpy(
        rs.integers(0, 256, (live, T, T), dtype=np.uint8)).to(cuda) \
        * torch.from_numpy(rs.random((live, T, T)) < 0.02).to(cuda)
    n_blocks = 64
    t_src = rs.integers(0, n_blocks, nt).astype(np.int32)
    t_dst = np.sort(rs.integers(0, n_blocks, nt)).astype(np.int32)
    tg = tiles.TiledGraph(
        prob=None, edge_id=None, tile_src=torch.from_numpy(t_src).to(cuda),
        tile_dst=torch.from_numpy(t_dst).to(cuda),
        dst_run_ptr=tiles.run_pointers(torch.from_numpy(t_dst).to(cuda),
                                       n_blocks),
        num_vertices=n_blocks * T, num_edges=0, tile_size=T)
    fr, vis = _masks(n_blocks * T, 64, 5, 0.3, cuda)
    ids = torch.arange(first, nt, 2, dtype=torch.int32, device=cuda)
    got = ops.fused_expand_q(tg, q8, fr, vis, 9, 2, tile_ids=ids)
    want = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst, fr, vis, 9,
                                  2, tile_ids=ids)
    assert bool(want.any()) and torch.equal(got, want)
    assert torch.equal(ops.fused_expand_q(tg, q8, fr, vis, 9, 2),
                       ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst,
                                              fr, vis, 9, 2))


def test_quantized_layout_equals_quantised_float32_stack(cuda):
    g = csr.dedupe(generators.powerlaw_cluster(5000, 6.0, prob=(0.0, 1.0),
                                               seed=3, device="cuda"))
    tg, q8 = tiles.quantized(g)
    tf = tiles.from_graph(g, edge_ids=False)
    assert torch.equal(q8, quantize_probs(tf.prob))
    assert torch.equal(tg.dst_run_ptr, tf.dst_run_ptr)


def test_q_traversal_at_p1_equals_csr_sweep(cuda):
    g = csr.dedupe(generators.powerlaw_cluster(5000, 6.0, prob=1.0, seed=7,
                                               device="cuda"))
    src, dst, _ = g.edges_numpy()      # dedupe leaves single edges at 1 - 1e-7
    g_rev = csr.transpose(csr.from_edges(src, dst, np.ones(len(src)), 5000,
                                         device="cuda"))
    tg, q8 = tiles.quantized(g_rev)
    for frontier in ("dense", "sparse"):
        starts = rrr.batch_starts(5000, 64, 0, 0)
        vis, levels, _ = tiled_traversal.run_fused_q_tiled(
            tg, q8, starts, 64, rrr.batch_seed(0, 0), frontier=frontier)
        dense = rrr.sample_batch(g_rev, 64, 0, 0)
        assert levels > 0 and torch.equal(vis, dense.visited)


# ------------------------------------------------------------- slot lists
@pytest.mark.parametrize("colors", [32, 96, 160, 256])
def test_slot_list_kernels_equal_plain_at_every_word_count(cuda, colors):
    """Both slot-list kernels ≡ their tile-form plain versions, W 1/3/5/8,
    on the dense grid and on compacted lists (empty, one source block,
    full), padding tiles and destination blocks no tile reaches."""
    tg = _tiled(3000, 20000, seed=colors, tile_size=128, dst_limit=2200,
                pad=3)
    q8 = quantize_probs(tg.prob)
    fr, vis = _masks(tg.padded_vertices, colors, colors, 0.3, cuda)
    act = torch.zeros(tg.num_blocks, dtype=torch.bool, device=cuda)
    lists = [None, tiles.active_tile_ids(tg.tile_src, act)]
    act[int(tg.tile_src[0])] = True
    lists.append(tiles.active_tile_ids(tg.tile_src, act))
    act[:] = True
    lists.append(tiles.active_tile_ids(tg.tile_src, act))
    for ids in lists:
        sel = slice(None) if ids is None else ids.long()
        got = ops.fused_expand(tg, fr, vis, 0xC0FFEE, 7, tile_ids=ids)
        want = ref.fused_expand_ref(tg.prob[sel], tg.edge_id[sel],
                                    tg.tile_src[sel], tg.tile_dst[sel], fr,
                                    vis, 0xC0FFEE, 7)
        assert torch.equal(got, want)
        got = ops.fused_expand_q(tg, q8, fr, vis, 0xC0FFEE, 7, tile_ids=ids)
        want = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst, fr, vis,
                                      0xC0FFEE, 7, tile_ids=ids)
        assert torch.equal(got, want)


def test_slot_list_kernels_merge_a_hub_destination(cuda):
    """Destination rows with 300 in-edges each: row 5's from three source
    blocks (runs of up to 128 neighbouring entries of one tile), rows 700
    and 4095's from anywhere (entries spread over many tiles).  The warp
    merge and the atomics lose no colour."""
    n = 4096
    rs = np.random.default_rng(1)
    hubs = np.repeat([5, 700, 4095], 300)
    src = np.concatenate([np.arange(1000, 1300), rs.integers(0, n, 600),
                          rs.integers(0, n, 5000)])
    dst = np.concatenate([hubs, rs.integers(0, n, 5000)])
    keep = src != dst
    g = csr.from_edges(src[keep], dst[keep],
                       rs.uniform(0.05, 0.5, keep.sum()).astype(np.float32),
                       n, dedupe=True, device="cuda")
    tg = tiles.from_graph(g)
    assert int((tiles.ic_slot_list(tg).dst_row == 700).sum()) >= 250
    q8 = quantize_probs(tg.prob)
    for colors, density in ((32, 0.5), (256, 0.05)):
        fr, vis = _masks(tg.padded_vertices, colors, colors, density, cuda)
        vis[[5, 700, 4095]] = fr[[5, 700, 4095]]
        got = ops.fused_expand(tg, fr, vis, 3, 1)
        want = ref.fused_expand_ref(tg.prob, tg.edge_id, tg.tile_src,
                                    tg.tile_dst, fr, vis, 3, 1)
        assert torch.equal(got, want) and bool(got[700].any())
        got = ops.fused_expand_q(tg, q8, fr, vis, 3, 1)
        want = ref.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst, fr, vis,
                                      3, 1)
        assert torch.equal(got, want) and bool(got[700].any())


def test_slot_list_kernels_replay_from_a_cuda_graph(cuda):
    """The output's memset and the kernel replay from a CUDA graph: new
    frontier words written into the captured buffers give the plain
    version's result for them."""
    tg = _tiled(3000, 20000, seed=4, tile_size=128, dst_limit=2200)
    q8 = quantize_probs(tg.prob)
    fr, vis = _masks(tg.padded_vertices, 64, 1, 0.3, cuda)
    ids = tiles.active_tile_ids(
        tg.tile_src, torch.ones(tg.num_blocks, dtype=torch.bool,
                                device=cuda))
    ops.fused_expand(tg, fr, vis, 9, 2, tile_ids=ids)
    ops.fused_expand_q(tg, q8, fr, vis, 9, 2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_ic = ops.fused_expand(tg, fr, vis, 9, 2, tile_ids=ids)
        out_q = ops.fused_expand_q(tg, q8, fr, vis, 9, 2)
    for seed in (2, 3):
        new_fr, new_vis = _masks(tg.padded_vertices, 64, seed, 0.3, cuda)
        fr.copy_(new_fr)
        vis.copy_(new_vis)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_ic, ref.fused_expand_ref(
            tg.prob, tg.edge_id, tg.tile_src, tg.tile_dst, fr, vis, 9, 2))
        assert torch.equal(out_q, ref.fused_expand_q_ref(
            q8, tg.tile_src, tg.tile_dst, fr, vis, 9, 2))


# ------------------------------------------------------ LT on its slot list
@pytest.mark.parametrize("colors", [32, 96, 160, 256])
def test_lt_slot_list_kernel_equals_plain_at_every_word_count(cuda, colors):
    """The LT kernel ≡ its tile-form plain version, W 1/3/5/8, on the dense
    grid and on compacted lists (empty, one source block, full), padding
    tiles and destination blocks no tile reaches; the list that
    `tiles.lt_cb_tiles` makes equals the one read from the stacks."""
    tg, cb = _lt_tiled(3000, 20000, seed=colors, tile_size=128,
                       dst_limit=2200, pad=3)
    slots = tiles.lt_slot_list(tg, cb)
    again = tiles.lt_slot_list_from_stack(tg, cb)
    for f in ("slot_ptr", "src_row", "dst_row", "value", "key"):
        assert torch.equal(getattr(slots, f), getattr(again, f))
    u = ref.lt_selection_uniforms(0xC0FFEE, tg.padded_vertices, colors,
                                  device=cuda)
    fr, vis = _masks(tg.padded_vertices, colors, colors, 0.3, cuda)
    act = torch.zeros(tg.num_blocks, dtype=torch.bool, device=cuda)
    lists = [None, tiles.active_tile_ids(tg.tile_src, act)]
    act[int(tg.tile_src[0])] = True
    lists.append(tiles.active_tile_ids(tg.tile_src, act))
    act[:] = True
    lists.append(tiles.active_tile_ids(tg.tile_src, act))
    for ids in lists:
        sel = slice(None) if ids is None else ids.long()
        before = ops.LAUNCHES["lt_select_expand"]
        got = ops.lt_select_expand(tg, cb, fr, vis, u, tile_ids=ids)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["lt_select_expand"] == before + 1
        want = ref.lt_select_expand_ref(tg.prob[sel], cb[sel],
                                        tg.tile_src[sel], tg.tile_dst[sel],
                                        fr, vis, u)
        assert torch.equal(got, want)
        assert torch.equal(got, ref.lt_select_expand_slots_ref(
            slots, fr, vis, u, tile_ids=ids))


def test_lt_slot_list_kernel_merges_a_hub_destination(cuda):
    """Destination rows with 300 in-edges each (LT-normalised, so each
    in-weight ~1/300 and one in-edge live per colour): the warp merge and
    the atomics lose no colour."""
    n = 4096
    rs = np.random.default_rng(2)
    src = np.concatenate([np.arange(1000, 1300), rs.integers(0, n, 600),
                          rs.integers(0, n, 5000)])
    dst = np.concatenate([np.repeat([5, 700, 4095], 300),
                          rs.integers(0, n, 5000)])
    keep = src != dst
    g = lt.normalize_lt_weights(csr.from_edges(
        src[keep], dst[keep],
        rs.uniform(0.05, 0.5, keep.sum()).astype(np.float32), n,
        dedupe=True, device="cuda"))
    tg = tiles.from_graph(g, edge_ids=False)
    cb = tiles.lt_cb_tiles(tg, g, lt.selection_cum_before(g))
    assert int((tiles.lt_slot_list(tg, cb).dst_row == 700).sum()) >= 250
    for colors in (32, 256):
        u = ref.lt_selection_uniforms(5, tg.padded_vertices, colors,
                                      device=cuda)
        fr, vis = _masks(tg.padded_vertices, colors, colors, 0.9, cuda)
        vis[[5, 700, 4095]] = fr[[5, 700, 4095]]
        for ids in (None, tiles.active_tile_ids(
                tg.tile_src, torch.ones(tg.num_blocks, dtype=torch.bool,
                                        device=cuda))):
            got = ops.lt_select_expand(tg, cb, fr, vis, u, tile_ids=ids)
            want = ref.lt_select_expand_ref(tg.prob, cb, tg.tile_src,
                                            tg.tile_dst, fr, vis, u)
            assert torch.equal(got, want) and bool(got[700].any())


def test_lt_slot_list_kernel_replays_from_a_cuda_graph(cuda):
    """The output's memset and the LT kernel replay from a CUDA graph on
    both grids: new frontier words written into the captured buffers give
    the plain version's result for them."""
    tg, cb = _lt_tiled(3000, 20000, seed=5, tile_size=128, dst_limit=2200)
    u = ref.lt_selection_uniforms(3, tg.padded_vertices, 64, device=cuda)
    fr, vis = _masks(tg.padded_vertices, 64, 1, 0.3, cuda)
    ids = tiles.active_tile_ids(
        tg.tile_src, torch.ones(tg.num_blocks, dtype=torch.bool,
                                device=cuda))
    ops.lt_select_expand(tg, cb, fr, vis, u)
    ops.lt_select_expand(tg, cb, fr, vis, u, tile_ids=ids)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dense = ops.lt_select_expand(tg, cb, fr, vis, u)
        listed = ops.lt_select_expand(tg, cb, fr, vis, u, tile_ids=ids)
    for seed in (2, 3):
        new_fr, new_vis = _masks(tg.padded_vertices, 64, seed, 0.3, cuda)
        fr.copy_(new_fr)
        vis.copy_(new_vis)
        graph.replay()
        torch.cuda.synchronize()
        want = ref.lt_select_expand_ref(tg.prob, cb, tg.tile_src,
                                        tg.tile_dst, fr, vis, u)
        assert torch.equal(dense, want) and torch.equal(listed, want)


# ------------------------------------------------------------ cover counts
def _cover_inputs(b, v, w, q, seed, offset=0):
    """Random (B, V, W) and (B, Q, W) int32 words on the GPU; ``offset``
    words shift the visited tensor's base off its allocation's start."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randint(-2 ** 31, 2 ** 31, (offset + b * v * w,),
                         dtype=torch.int32, device="cuda", generator=g)
    act = torch.randint(-2 ** 31, 2 ** 31, (b, q, w), dtype=torch.int32,
                        device="cuda", generator=g)
    return flat[offset:].view(b, v, w), act


@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("b,v", [(1, 0), (64, 0), (1, 1), (64, 1),
                                 (1, 257), (64, 257), (1, 65536),
                                 (64, 65536)])
def test_cover_counts_both_forms_equal_plain(cuda, b, v, w):
    """One active mask (``cover_counts``) and eight (``cover_counts_multi``)
    against the plain versions, exactly; 16-byte loads where each slab is
    aligned and word loads where it is not (V = 1, 257 at odd W)."""
    vis, act = _cover_inputs(b, v, w, 8, seed=b * 100 + w)
    before = dict(ops.LAUNCHES)
    one = ops.cover_counts(vis, act[:, 0])
    many = ops.cover_counts_multi(vis, act)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cover_counts"] == before["cover_counts"] + 2
    assert ops.LAUNCHES["cover_counts_multi"] == \
        before["cover_counts_multi"] + 1
    assert one.shape == (v,) and many.shape == (8, v)
    assert torch.equal(one, ref.cover_counts_ref(vis, act[:, 0]))
    assert torch.equal(many, ref.cover_counts_multi_ref(vis, act))


@pytest.mark.parametrize("q", [1, 3, 8, 11])
@pytest.mark.parametrize("b,v", [(1, 4100), (64, 4100), (60, 65536)])
def test_cover_counts_batch_ranges_offset_base_and_mask_count(cuda, q, b, v):
    """The launcher's split of B over the grid, reached by B: one batch
    (one range: stores, nothing zeroed), 64 batches of a narrow V (a range
    per batch: atomics into zeroed counts), 60 batches of the pool's V
    (ranges of several batches, the last one short); a base 4 bytes off
    16-byte alignment, Q below, at and above one launch's eight masks;
    and W = 9 (rows past the tile kernels' 8 words)."""
    from repro_torch.kernels.coverage import cover_counts_cuda
    for w, offset in ((2, 0), (2, 1), (9, 0)):
        vis, act = _cover_inputs(b, v, w, q, seed=q + b, offset=offset)
        got = cover_counts_cuda(vis, act)
        assert torch.equal(got, ref.cover_counts_multi_ref(vis, act))


def test_cover_counts_replays_from_a_cuda_graph_and_on_two_streams(cuda):
    """The zeroing and the kernel replay from a CUDA graph (new words in
    the captured buffers give their counts); launches queued on two
    streams at once, on inputs of their own, each give the plain
    version's counts."""
    vis, act = _cover_inputs(64, 65536, 2, 8, seed=1)
    ops.cover_counts_multi(vis, act)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        one = ops.cover_counts(vis, act[:, 0])
        many = ops.cover_counts_multi(vis, act)
    for seed in (2, 3):
        new_vis, new_act = _cover_inputs(64, 65536, 2, 8, seed=seed)
        vis.copy_(new_vis)
        act.copy_(new_act)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(one, ref.cover_counts_ref(vis, act[:, 0]))
        assert torch.equal(many, ref.cover_counts_multi_ref(vis, act))
    ins = [_cover_inputs(64, 65536, 2, 8, seed=s) for s in (11, 12)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(10):
        for (v, a), stream, got in zip(ins, streams, outs):
            with torch.cuda.stream(stream):
                got.append(ops.cover_counts_multi(v, a))
    torch.cuda.synchronize()
    for (v, a), got in zip(ins, outs):
        want = ref.cover_counts_multi_ref(v, a)
        assert all(torch.equal(o, want) for o in got)


# ------------------------------------------------ the serving lifecycle
def _lifecycle_graph(device):
    return csr.dedupe(generators.powerlaw_cluster(
        600, 6.0, prob=(0.05, 0.3), seed=17, device=device))


def _lifecycle_store(device, diffusion, frontier, batches=6):
    from repro_torch.serve.influence import PoolConfig, SketchStore
    spec = SamplerSpec(diffusion=diffusion, backend="kernel", num_colors=64,
                       master_seed=9, tile_size=64, frontier=frontier)
    store = SketchStore(_lifecycle_graph(device),
                        PoolConfig(max_batches=16, spec=spec))
    store.ensure(batches)
    store.visited_stack()
    return store


@pytest.mark.parametrize("diffusion,frontier", [("ic", "dense"),
                                                ("lt", "sparse")])
def test_stream_delta_on_the_kernel_backend(cuda, diffusion, frontier):
    """An IC / LT delta on the kernel backend: the card's incremental pool
    equals its cold rebuild and the CPU's plain-version pool after the same
    delta, word for word, and the tile kernel ran on the new pair."""
    from repro_torch import stream
    pools = {}
    for device in ("cuda", "cpu"):
        store = _lifecycle_store(device, diffusion, frontier)
        tracker = stream.DirtySlotTracker.for_store(store)
        delta = stream.random_delta(store.graph, np.random.default_rng(21),
                                    num_deletes=6, num_inserts=6)
        ops.reset_launches()
        report = stream.incremental_refresh(store, tracker, delta)
        assert report.dirty_slots > 0
        if device == "cuda":
            kernel = "lt_select_expand" if diffusion == "lt" \
                else "fused_expand"
            assert ops.LAUNCHES[kernel] > 0
            cold = stream.cold_rebuild_batches(store)
            for got, want in zip(store.batches, cold):
                assert torch.equal(got.visited, want.visited)
        pools[device] = convert.masks_to_numpy(store.visited_stack())
    np.testing.assert_array_equal(pools["cuda"], pools["cpu"])


def test_dirty_tracker_bits_from_cuda_masks_equal_host_bits(cuda):
    """The tracker reduces a CUDA mask on the card; its packed bytes equal
    ``np.packbits`` of the host mask's row-block flags."""
    from repro_torch.stream import DirtySlotTracker
    rs = np.random.default_rng(5)
    for v, tile_rows, density in ((1000, 64, 0.01), (4096, 128, 0.001),
                                  (777, 7, 0.05), (300, 128, 0.0)):
        words = (rs.random((v, 3)) < density) * rs.integers(
            1, 2 ** 32, (v, 3), dtype=np.uint64)
        host = words.astype(np.uint32)
        tracker = DirtySlotTracker(v, tile_rows)
        got = tracker._record_bits(convert.masks_from_numpy(host, "cuda"))
        rows = np.concatenate([(host != 0).any(1),
                               np.zeros((-v) % tile_rows, bool)])
        want = np.packbits(rows.reshape(-1, tile_rows).any(1))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("saved_on,restored_on", [("cuda", "cpu"),
                                                  ("cpu", "cuda")])
def test_snapshot_crosses_between_card_and_host(cuda, tmp_path, saved_on,
                                                restored_on):
    """A pool saved from CUDA tensors restores bit for bit on the CPU, and
    the reverse, with every counter."""
    from repro_torch.serve.influence import SketchStore
    store = _lifecycle_store(saved_on, "ic", "dense", batches=4)
    store.refresh(0.5)
    store.graph_epoch = 3
    store.save(str(tmp_path))
    back = SketchStore.restore(str(tmp_path),
                               _lifecycle_graph(restored_on), store.config)
    assert back.visited_stack().device.type == restored_on
    np.testing.assert_array_equal(
        convert.masks_to_numpy(back.visited_stack()),
        convert.masks_to_numpy(store.visited_stack()))
    assert back.version == store.version
    assert back.next_batch_index == store.next_batch_index
    assert back.batch_epochs == store.batch_epochs
    assert [b.batch_index for b in back.batches] == \
        [b.batch_index for b in store.batches]


@pytest.mark.parametrize("diffusion", ["ic", "lt"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_shard_local_tile_kernels_equal_plain(cuda, diffusion, shards):
    """A row shard's slot list (`graph.partition.ShardLayout`) through the
    kernels: the global (Vp, W) frontier in, the shard's (rows, W) visited
    rows out, against the plain version on the same list, and the shards'
    rows together against the one-device kernel on the whole layout."""
    from repro_torch.graph import partition
    g = csr.dedupe(generators.powerlaw_cluster(3000, 6.0, prob=0.3, seed=4,
                                               device="cuda"))
    if diffusion == "lt":
        g = lt.normalized(g)
        keys = np.asarray(lt.selection_cum_before(g), np.float32) \
            .view(np.int32)
    else:
        keys = np.arange(g.num_edges, dtype=np.int32)
    prob = g.edges_numpy()[2]
    layout0 = partition.shard_layout(g, 128, shards, 0)
    vp, rows = layout0.padded_vertices, layout0.rows
    fr, vis = _masks(vp, 64, shards, 0.05, cuda)
    parts = []
    for s in range(shards):
        layout = partition.shard_layout(g, 128, shards, s)
        slots = layout.slot_list(prob, keys, cuda)
        local = vis[s * rows:(s + 1) * rows].contiguous()
        if diffusion == "lt":
            u = ref.lt_selection_uniforms(7, rows, 64, row_base=s * rows,
                                          device=cuda)
            before = ops.LAUNCHES["lt_select_expand"]
            got = ops.lt_select_expand_slots(slots, fr, local, u)
            want = ref.lt_select_expand_slots_ref(slots, fr, local, u)
            assert ops.LAUNCHES["lt_select_expand"] == before + 1
        else:
            before = ops.LAUNCHES["fused_expand"]
            got = ops.fused_expand_slots(slots, fr, local, 0xC0FFEE, 3)
            want = ref.fused_expand_slots_ref(slots, fr, local, 0xC0FFEE, 3)
            assert ops.LAUNCHES["fused_expand"] == before + 1
        torch.cuda.synchronize()
        assert got.shape == (rows, 2) and torch.equal(got, want)
        parts.append(got)
    whole = partition.shard_layout(g, 128, 1, 0)
    slots = whole.slot_list(prob, keys, cuda)
    fr1 = fr[:whole.padded_vertices].contiguous()
    vis1 = vis[:whole.padded_vertices].contiguous()
    if diffusion == "lt":
        one = ops.lt_select_expand_slots(
            slots, fr1, vis1, ref.lt_selection_uniforms(
                7, whole.rows, 64, device=cuda))
    else:
        one = ops.fused_expand_slots(slots, fr1, vis1, 0xC0FFEE, 3)
    assert torch.equal(torch.cat(parts)[:whole.padded_vertices], one)


@pytest.mark.parametrize("shards", [2, 4])
def test_cover_counts_on_a_row_slice_equals_plain(cuda, shards):
    """`cover_counts` and `cover_counts_multi` on one rank's (B/D, V/M, W)
    block of a pool, against the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(shards)
    vis = torch.randint(-2 ** 31, 2 ** 31, (16, 65536 // shards, 2),
                        dtype=torch.int32, device=cuda, generator=g)
    act = torch.randint(-2 ** 31, 2 ** 31, (16, 8, 2), dtype=torch.int32,
                        device=cuda, generator=g)
    got = ops.cover_counts(vis, act[:, 0])
    multi = ops.cover_counts_multi(vis, act)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.cover_counts_ref(vis, act[:, 0]))
    assert torch.equal(multi, ref.cover_counts_multi_ref(vis, act))


# ------------------------------------------- MoE, MLA and SSD (LM)
@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_moe_mla_model_on_the_card_equals_the_host(cuda, arch):
    """The smoke model's float32 prefill logits and aux, and 4 decode steps
    (MLA's absorbed decode; maverick's and zamba2's GQA on the flash
    kernels; the SSD recurrence on its cached state), on the card within
    1e-4 of the same weights on the host; the router, a float32 tensor,
    picks the same experts (capacity 1.25 drops tokens in both)."""
    import copy
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import decode, model

    cfg = dataclasses.replace(registry.smoke(arch), num_patches=0)
    host = model.init_params(cfg, seed=3, device="cpu")
    card = copy.deepcopy(host).to(cuda)   # Module.to moves in place
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    outs = {}
    for name, params, dev in (("host", host, torch.device("cpu")),
                              ("card", card, cuda)):
        t = tokens.to(dev)
        logits, aux, _ = model.forward(params, cfg, {"tokens": t})
        caches = decode.init_caches(cfg, 2, 20, dev)
        for i in range(16):
            decode.decode_step(params, cfg, caches, t[:, i:i + 1], i)
        steps = [decode.decode_step(params, cfg, caches, t[:, i:i + 1],
                                    16 + i)[0] for i in range(4)]
        outs[name] = [logits.cpu(), aux.cpu(), torch.cat(steps, 1).cpu()]
    for got, want in zip(outs["card"], outs["host"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_moe_scatter_on_the_card_repeats_bit_for_bit(cuda):
    """bf16 dispatch and combine use no atomics: two runs on the card give
    the same bits, at a prefill's capacity (tokens dropped) and decode's."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import mlp

    cfg = dataclasses.replace(registry.smoke("deepseek-v3-671b"),
                              dtype="bfloat16", num_experts=16)
    p = mlp.init_moe(torch.Generator(device=cuda).manual_seed(0), cfg)
    for shape in ((4, 512, cfg.d_model), (4, 1, cfg.d_model)):
        x = torch.randn(shape, generator=torch.Generator(device=cuda)
                        .manual_seed(1), device=cuda).bfloat16()
        a, aux_a = mlp.moe_forward(p, x, cfg)
        b, aux_b = mlp.moe_forward(p, x, cfg)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_vlm_patched_model_on_the_card_equals_the_host(cuda):
    """phi-3-vision's smoke model (4 patches of 1,024, float32): a prefill
    of the patches and 28 tokens and 4 decode steps on the card (its flash
    calls on the simt and decode routes at head dim 16) within 1e-4 of the
    same weights on the host."""
    import copy
    from repro_torch.configs import registry
    from repro_torch.models import decode, init, model
    from repro_torch.serve import engine

    cfg = registry.smoke("phi-3-vision-4.2b")
    host = model.init_params(cfg, seed=3, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    patches = torch.from_numpy(init.numpy_patch_embeds(cfg, 4, 2))
    L = cfg.num_patches + 28
    outs = {}
    for name, params, dev in (("host", host, torch.device("cpu")),
                              ("card", card, cuda)):
        last, caches, plen = engine.prefill(params, cfg, {
            "tokens": tokens[:, :28].to(dev),
            "patch_embeds": patches.to(dev)}, L + 4)
        assert plen == L
        steps = [decode.decode_step(params, cfg, caches,
                                    tokens[:, 28 + i:29 + i].to(dev),
                                    L + i)[0] for i in range(4)]
        outs[name] = [last.cpu(), torch.cat(steps, 1).cpu()]
    for got, want in zip(outs["card"], outs["host"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
