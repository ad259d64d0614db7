"""Port ≡ reference: CSR graphs, generators and the block-sparse tile layout.

CSR edge ids are the RNG counters, so every array must match exactly —
including the padding edges and the ``pad_tiles_to`` padding tiles."""
import numpy as np
import pytest
import torch

from repro.core import tiles as jtiles
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch import device as device_lib
from repro_torch.core import tiles as ttiles
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _assert_graph_equal(gj, gt):
    assert (gj.num_vertices, gj.num_edges, gj.padded_edges) == \
        (gt.num_vertices, gt.num_edges, gt.padded_edges)
    for f in ("indptr", "src", "dst"):
        np.testing.assert_array_equal(np.asarray(getattr(gj, f)),
                                      getattr(gt, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(gj.prob), gt.prob.numpy())
    np.testing.assert_array_equal(np.asarray(gj.degrees()),
                                  gt.degrees().numpy())


def _edges(seed, n=200, e=900, dup=True):
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n, e)
    dst = (src + 1 + rs.integers(0, n - 1, e)) % n
    if dup:                                   # parallel edges to merge
        src = np.concatenate([src, src[:100]])
        dst = np.concatenate([dst, dst[:100]])
    prob = rs.uniform(0, 1, len(src)).astype(np.float32)
    return src, dst, prob, n


@pytest.mark.parametrize("dedupe", [False, True])
@pytest.mark.parametrize("pad_to", [None, 1200])
def test_from_edges_matches_reference(dedupe, pad_to):
    src, dst, prob, n = _edges(0)
    gj = jcsr.from_edges(src, dst, prob, n, pad_to=pad_to, dedupe=dedupe)
    gt = tcsr.from_edges(src, dst, prob, n, pad_to=pad_to, dedupe=dedupe,
                         device="cpu")
    _assert_graph_equal(gj, gt)
    _assert_graph_equal(jcsr.transpose(gj), tcsr.transpose(gt))
    _assert_graph_equal(jcsr.dedupe(gj), tcsr.dedupe(gt))


@pytest.mark.parametrize("n,prob", [(300, 0.25), (500, (0.0, 1.0))])
def test_powerlaw_cluster_matches_reference(n, prob):
    gj = jgen.powerlaw_cluster(n, 6.0, prob=prob, seed=7)
    gt = tgen.powerlaw_cluster(n, 6.0, prob=prob, seed=7, device="cpu")
    _assert_graph_equal(gj, gt)
    _assert_graph_equal(jcsr.dedupe(gj), tcsr.dedupe(gt))


def test_dedupe_edges_matches_reference():
    src, dst, prob, _ = _edges(1)
    for a, b in zip(jtiles.dedupe_edges(src, dst, prob),
                    ttiles.dedupe_edges(src, dst, prob)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile_size", [32, 64, 128])
@pytest.mark.parametrize("pad", [0, 5])
def test_tiles_match_reference(tile_size, pad):
    gj = jcsr.transpose(jcsr.dedupe(jgen.powerlaw_cluster(
        400, 6.0, prob=(0.0, 1.0), seed=tile_size)))
    gt = convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), gj.num_vertices, gj.num_edges, device="cpu")
    nt = jtiles.from_graph(gj, tile_size).num_tiles
    pad_to = nt + pad if pad else None
    tj = jtiles.from_graph(gj, tile_size, pad_tiles_to=pad_to)
    tt = ttiles.from_graph(gt, tile_size, pad_tiles_to=pad_to)
    assert (tj.num_tiles, tj.padded_vertices, tj.num_edges) == \
        (tt.num_tiles, tt.padded_vertices, tt.num_edges)
    np.testing.assert_array_equal(np.asarray(tj.prob), tt.prob.numpy())
    np.testing.assert_array_equal(np.asarray(tj.edge_id),
                                  tt.edge_id.numpy().view(np.uint32))
    for f in ("tile_src", "tile_dst"):
        np.testing.assert_array_equal(np.asarray(getattr(tj, f)),
                                      getattr(tt, f).numpy(), err_msg=f)
    # dst_run_ptr: block b's tiles are exactly [ptr[b], ptr[b+1]).
    ptr = tt.dst_run_ptr.numpy()
    td = tt.tile_dst.numpy()
    assert ptr.shape == (tt.num_blocks + 1,) and ptr[-1] == tt.num_tiles
    for b in range(tt.num_blocks):
        assert (td[ptr[b]:ptr[b + 1]] == b).all()
        assert (td == b).sum() == ptr[b + 1] - ptr[b]
    # It replaces the reference's first_of_dst: the run starts are exactly
    # the first tiles of the non-empty runs (padding tiles never start one).
    first = np.zeros(tt.num_tiles, np.int32)
    first[ptr[:-1][ptr[1:] > ptr[:-1]]] = 1
    np.testing.assert_array_equal(np.asarray(tj.first_of_dst), first)
    slot_j, nt_j = jtiles.edge_slot_map(gj, tile_size)
    slot_t, nt_t = ttiles.edge_slot_map(gt, tile_size)
    np.testing.assert_array_equal(slot_j, slot_t)
    assert nt_j == nt_t


def test_tiles_refuse_parallel_edges():
    src, dst, prob, n = _edges(2)
    gt = tcsr.from_edges(src, dst, prob, n, device="cpu")
    with pytest.raises(ValueError, match="parallel edges"):
        ttiles.from_graph(gt)


def test_pad_mask_rows_matches_reference():
    rs = np.random.default_rng(3)
    m = rs.integers(0, 2 ** 32, (300, 2), dtype=np.uint64).astype(np.uint32)
    got = ttiles.pad_mask_rows(convert.masks_from_numpy(m, "cpu"), 384)
    np.testing.assert_array_equal(
        convert.masks_to_numpy(got),
        np.asarray(jtiles.pad_mask_rows(m, 384)))


def test_cuda_request_without_gpu_raises():
    """Entry points default to cuda and never fall back to the CPU."""
    src, dst, prob, n = _edges(4)
    if torch.cuda.is_available():
        assert tcsr.from_edges(src, dst, prob, n).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_lib.resolve("cuda")
    with pytest.raises(RuntimeError):
        tcsr.from_edges(src, dst, prob, n)          # default device is cuda
