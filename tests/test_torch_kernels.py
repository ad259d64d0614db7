"""Port ≡ reference for the two kernels of the IC slice.

On CPU tensors the port's wrappers (`repro_torch.kernels.ops`) run the
kernels' plain PyTorch versions; here they are held, bit for bit, against
the reference's Pallas kernels in interpret mode (through
``repro.kernels.ops``, as the reference's own tests run them).  The CUDA
kernels themselves are held against the same plain versions on the GPU
(`tests/test_torch_cuda.py`, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rrr as jrrr
from repro.core import tiles as jtiles
from repro.core import traversal as jtr
from repro.graph import csr as jcsr
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import tiles as ttiles
from repro_torch.kernels import fused_expand as tfe
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _pair(n, e, p, *, seed, dst_limit=None, pad=0, tile_size=128):
    """(reference tiles, port tiles, reference CSR graph) of one
    dedupe-clean random graph.
    ``dst_limit`` keeps destinations below it, so the blocks above have no
    tile; ``pad`` appends ``pad_tiles_to`` padding tiles."""
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n, e)
    dst = rs.integers(0, dst_limit or n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    prob = (rs.uniform(*p, len(src)) if isinstance(p, tuple)
            else np.full(len(src), p)).astype(np.float32)
    gj = jcsr.from_edges(src, dst, prob, n, dedupe=True)
    gt = convert.graph_from_numpy(
        np.asarray(gj.indptr), np.asarray(gj.src), np.asarray(gj.dst),
        np.asarray(gj.prob), n, gj.num_edges, device="cpu")
    nt = jtiles.from_graph(gj, tile_size).num_tiles
    pad_to = nt + pad if pad else None
    return (jtiles.from_graph(gj, tile_size, pad_tiles_to=pad_to),
            ttiles.from_graph(gt, tile_size, pad_tiles_to=pad_to), gj)


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


def _expand_both(tj, tt, fr, vis, seed, level):
    want = np.asarray(jops.fused_expand(tj, jnp.asarray(fr), jnp.asarray(vis),
                                        seed, level))
    got = tops.fused_expand(tt, convert.masks_from_numpy(fr, "cpu"),
                            convert.masks_from_numpy(vis, "cpu"), seed, level)
    return convert.masks_to_numpy(got), want


@pytest.mark.parametrize("tile_size", [32, 64, 128])
@pytest.mark.parametrize("colors", [32, 64, 96])
def test_fused_expand_plain_matches_pallas(tile_size, colors):
    tj, tt, _ = _pair(300, 1500, (0.1, 0.9), seed=tile_size + colors,
                      tile_size=tile_size)
    fr, vis = _masks(tt.padded_vertices, colors, seed=colors, density=0.3)
    got, want = _expand_both(tj, tt, fr, vis, 0xDEADBEEF, 3)
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("p", [0.0, 1.0, (0.0, 0.05)])
def test_fused_expand_edge_probabilities(p):
    tj, tt, _ = _pair(256, 1200, p, seed=7, tile_size=64)
    fr, vis = _masks(tt.padded_vertices, 64, seed=8, density=0.5)
    got, want = _expand_both(tj, tt, fr, vis, 5, 0)
    np.testing.assert_array_equal(got, want)
    if p == 0.0:
        assert not got.any()


def test_fused_expand_empty_frontier_blocks_without_tiles_and_padding():
    """Destination blocks no tile reaches write 0 (the reference masks them
    after its kernel); padding tiles are no-ops; an empty frontier expands
    to nothing."""
    tj, tt, _ = _pair(480, 2000, (0.2, 1.0), seed=9, dst_limit=200, pad=6,
                      tile_size=32)
    assert tt.num_blocks > int(tt.tile_dst.max()) + 1     # empty dst blocks
    ptr = tt.dst_run_ptr.numpy()
    assert (ptr[1:] == ptr[:-1]).any()
    fr, vis = _masks(tt.padded_vertices, 64, seed=10, density=0.4)
    got, want = _expand_both(tj, tt, fr, vis, 77, 12)
    np.testing.assert_array_equal(got, want)
    empty = np.zeros_like(fr)
    got, want = _expand_both(tj, tt, empty, vis, 77, 12)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_fused_expand_one_traversal_level_matches_csr_step():
    """The port's tile expansion ≡ the reference's CSR sweep on a first
    level (coupled RNG: both draw by CSR edge id)."""
    n = 500
    _, tt, gj = _pair(n, 4000, (0.2, 0.8), seed=3)
    fr = jtr.init_frontier(n, 64, jrrr.batch_starts(n, 64, 0, 0))
    want, _, _ = jtr.fused_step(gj, fr, jnp.zeros_like(fr), jnp.int32(0),
                                jnp.uint32(11))
    fr_p = np.zeros((tt.padded_vertices, 2), np.uint32)
    fr_p[:n] = np.asarray(fr)
    fr_t = convert.masks_from_numpy(fr_p, "cpu")
    got = tops.fused_expand(tt, fr_t, fr_t, 11, 0)
    np.testing.assert_array_equal(convert.masks_to_numpy(got)[:n],
                                  np.asarray(want))
    assert np.asarray(want).any()


@pytest.mark.parametrize("b,v,colors", [(1, 300, 64), (3, 256, 96),
                                        (4, 130, 32)])
def test_cover_counts_plain_matches_pallas(b, v, colors):
    """The port fuses the batch sum every caller takes
    (``cover_counts_batched(...).sum(0)`` in the reference)."""
    rs = np.random.default_rng(b * v)
    w = -(-colors // 32)
    vis = rs.integers(0, 2 ** 32, (b, v, w), dtype=np.uint64) \
        .astype(np.uint32)
    act = rs.integers(0, 2 ** 32, (b, w), dtype=np.uint64).astype(np.uint32)
    act[0] = 0xFFFFFFFF
    want = np.asarray(jops.cover_counts_batched(jnp.asarray(vis),
                                                jnp.asarray(act)).sum(0))
    got = tops.cover_counts(convert.masks_from_numpy(vis, "cpu"),
                            convert.masks_from_numpy(act, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    one = tref.cover_counts_ref(convert.masks_from_numpy(vis[0], "cpu"),
                                convert.masks_from_numpy(act[0], "cpu"))
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jops.cover_counts(jnp.asarray(vis[0]),
                                                  jnp.asarray(act[0]))))


def test_wrappers_count_only_kernel_launches_and_refuse_mixed_devices():
    tj, tt, _ = _pair(256, 800, 0.5, seed=1, tile_size=64)
    fr, vis = _masks(tt.padded_vertices, 64, seed=2, density=0.3)
    before = dict(tops.LAUNCHES)
    _expand_both(tj, tt, fr, vis, 1, 1)
    tops.cover_counts(convert.masks_from_numpy(vis[None], "cpu"),
                      convert.masks_from_numpy(fr[:1], "cpu"))
    assert tops.LAUNCHES == before        # plain versions on CPU: no launch
    with pytest.raises(ValueError, match="devices"):
        tops.cover_counts(torch.zeros((1, 4, 2), dtype=torch.int32),
                          torch.zeros((1, 2), dtype=torch.int32,
                                      device="meta"))


def test_fused_expand_wrapper_rejects_a_frontier_shorter_than_visited():
    """The CUDA wrapper checks its shapes before it builds or launches: a
    frontier without every row the slot list reads is refused, not read
    out of bounds (the check runs on any device, so on CPU tensors
    here)."""
    _, tt, _ = _pair(256, 800, 0.5, seed=4, tile_size=64)
    fr, vis = _masks(tt.padded_vertices, 64, seed=5, density=0.3)
    fr_t = convert.masks_from_numpy(fr[:64], "cpu")
    vis_t = convert.masks_from_numpy(vis, "cpu")
    with pytest.raises(ValueError, match="256 source and 256 destination"):
        tfe.fused_expand_cuda(ttiles.ic_slot_list(tt), fr_t, vis_t, 1, 0)
