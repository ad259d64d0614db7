"""Port ≡ reference: counter RNG and packed colour bitmasks.

The same numpy inputs (from a seed) go through ``repro.core.{rng,bitmask}``
and ``repro_torch.core.{rng,bitmask}``; every output is an integer (or a
float32 built exactly from one), so equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmask as jbm
from repro.core import rng as jrng
from repro_torch import convert
from repro_torch.core import bitmask as tbm
from repro_torch.core import rng as trng

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _u32(rs, *shape):
    return rs.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(u32_array):
    return convert.masks_from_numpy(u32_array, "cpu")


def _np(t):
    return convert.masks_to_numpy(t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_u32_and_uniform_match_reference(seed):
    rs = np.random.default_rng(seed)
    s, lv = _u32(rs, 1)[0], _u32(rs, 1)[0]
    eid, wid = _u32(rs, 500), _u32(rs, 500)
    want = np.asarray(jrng.hash_u32(s, lv, eid, wid))
    got = trng.hash_u32(int(s), int(lv), torch.from_numpy(eid.astype(np.int64)),
                        torch.from_numpy(wid.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        trng.uniform_from_u32(got).numpy(),
        np.asarray(jrng.uniform_from_u32(jnp.asarray(want))))
    # int32 bit-pattern inputs take the same path as uint32 values.
    got32 = trng.hash_u32(int(s), int(lv), _t(eid), _t(wid))
    np.testing.assert_array_equal(got32.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("lanes", [32, 17])
def test_bernoulli_word_and_pack_match_reference(lanes):
    rs = np.random.default_rng(lanes)
    eid = _u32(rs, 64, 3)
    prob = rs.uniform(0, 1, (64, 3)).astype(np.float32)
    prob[0] = 0.0
    prob[1] = 1.0
    want = np.asarray(jrng.bernoulli_word(jnp.uint32(9), jnp.uint32(4),
                                          jnp.asarray(eid), jnp.uint32(2),
                                          jnp.asarray(prob), lanes=lanes))
    got = trng.bernoulli_word(9, 4, torch.from_numpy(eid.astype(np.int64)), 2,
                              torch.from_numpy(prob), lanes=lanes)
    np.testing.assert_array_equal(_np(got), want)
    bools = rs.random((40, lanes)) < 0.5
    np.testing.assert_array_equal(
        _np(trng.pack_bool_word(torch.from_numpy(bools))),
        np.asarray(jrng.pack_bool_word(jnp.asarray(bools))))


@pytest.mark.parametrize("num_colors", [1, 31, 32, 33, 64, 96, 100])
def test_tail_mask_and_words(num_colors):
    assert tbm.num_words(num_colors) == jbm.num_words(num_colors)
    np.testing.assert_array_equal(tbm.color_tail_mask(num_colors),
                                  jbm.color_tail_mask(num_colors))
    np.testing.assert_array_equal(
        _np(tbm.tail_mask_tensor(num_colors, "cpu")),
        jbm.color_tail_mask(num_colors))


def test_popcount_pack_unpack_count_match_reference():
    rs = np.random.default_rng(3)
    m = _u32(rs, 50, 3)
    m[0] = 0xFFFFFFFF
    m[1] = 0x80000000
    m[2] = 0
    jm, tm = jnp.asarray(m), _t(m)
    np.testing.assert_array_equal(tbm.popcount(tm).numpy(),
                                  np.asarray(jbm.popcount(jm)).astype(np.int32))
    np.testing.assert_array_equal(tbm.count_colors(tm).numpy(),
                                  np.asarray(jbm.count_colors(jm)))
    np.testing.assert_array_equal(tbm.unpack_bits(tm).numpy(),
                                  np.asarray(jbm.unpack_bits(jm)))
    np.testing.assert_array_equal(_np(tbm.pack_bits(tbm.unpack_bits(tm))), m)
    assert tbm.any_set(tm) and not tbm.any_set(torch.zeros_like(tm))
    assert tbm.count_colors(tm).dtype == torch.int32


def test_set_color_ors_duplicate_rows():
    """Several colours starting at one vertex must all be set."""
    rs = np.random.default_rng(4)
    items = rs.integers(0, 6, 70)              # many duplicates
    colors = np.arange(70)
    want = np.asarray(jbm.set_color(jbm.make_mask(6, 70),
                                    jnp.asarray(items), jnp.asarray(colors)))
    got = tbm.set_color(tbm.make_mask(6, 70, "cpu"), torch.from_numpy(items),
                        torch.from_numpy(colors))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("unique", [False, True])
def test_scatter_or_words_match_reference(unique):
    """The port has only the duplicate-OR path; on distinct indices it must
    equal the reference's ``unique=True`` packed path too."""
    rs = np.random.default_rng(5 + unique)
    dst = _u32(rs, 12, 3)
    if unique:
        flat = rs.choice(36, 20, replace=False)
        rows, words = flat // 3, flat % 3
    else:
        rows, words = rs.integers(0, 12, 40), rs.integers(0, 3, 40)
    vals = _u32(rs, len(rows))
    want = np.asarray(jbm.scatter_or_words(
        jnp.asarray(dst), jnp.asarray(rows), jnp.asarray(words),
        jnp.asarray(vals), unique=unique))
    got = tbm.scatter_or_words(_t(dst), torch.from_numpy(rows),
                               torch.from_numpy(words), _t(vals))
    np.testing.assert_array_equal(_np(got), want)


def test_i32_wraps_explicitly():
    vals = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    np.testing.assert_array_equal(
        tbm.i32(vals).numpy().view(np.uint32),
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32))
    np.testing.assert_array_equal(tbm.u32(tbm.i32(vals)).numpy(), vals.numpy())
