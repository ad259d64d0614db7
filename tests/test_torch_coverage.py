"""Port ≡ reference for the coverage counts of several active masks at once.

The serving engine's marginal gains count every query slot's active mask
against the pool in one launch (`repro_torch.kernels.ops.cover_counts_multi`,
plain version `kernels.ref.cover_counts_multi_ref`), where the reference
maps the batched Pallas kernel over the slots
(``repro/serve/influence/engine.py:109-113``).  Here the plain version is
held against that map, and the engine's marginal counts and answers
against the reference engine's, bit for bit.  The CUDA kernel is held
against the same plain version on the GPU (`tests/test_torch_cuda.py`,
``chip_smoke.py``).  Tolerance: exact (integer counts; the answers are
those counts times n/θ in float64 on both sides)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.launch import serve_influence as jlaunch
from repro.sampling import SamplerSpec as JSpec
from repro.serve import influence as jserve
from repro.serve.influence import engine as jengine
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.launch import serve_influence as tlaunch
from repro_torch.serve import influence as tserve
from repro_torch.serve.influence import engine as tengine

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _words(rs, shape):
    return rs.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


@functools.partial(jax.jit, static_argnames=("v",))
def _pallas_per_slot(vis, act_q, v):
    """The reference's counts per slot: ``cover_counts_batched(...).sum(0)``
    mapped over Q, on rows padded with zeros to the Pallas kernel's block
    of 128 (zero rows count 0), cut back to ``v``."""
    return jax.lax.map(lambda a: jops.cover_counts_batched(vis, a).sum(0),
                       jnp.swapaxes(act_q, 0, 1))[:, :v]


@pytest.mark.parametrize("v", [1, 130, 257])
@pytest.mark.parametrize("w", [1, 2, 5, 8])
@pytest.mark.parametrize("q", [1, 3, 8])
def test_multi_plain_equals_the_reference_map_over_slots(q, w, v):
    rs = np.random.default_rng(q * 100 + w * 10 + v)
    b = 3
    vis = _words(rs, (b, v, w))
    act = _words(rs, (b, q, w))
    act[0, 0] = 0xFFFFFFFF
    act[1, -1] = 0
    vp = -(-v // 128) * 128
    padded = np.zeros((b, vp, w), np.uint32)
    padded[:, :v] = vis
    want = np.asarray(_pallas_per_slot(jnp.asarray(padded), jnp.asarray(act),
                                       v))
    before = dict(ops.LAUNCHES)
    got = ops.cover_counts_multi(convert.masks_from_numpy(vis, "cpu"),
                                 convert.masks_from_numpy(act, "cpu"))
    assert ops.LAUNCHES == before          # the plain version: no launch
    assert got.dtype == torch.int32 and got.shape == (q, v)
    np.testing.assert_array_equal(got.numpy(), want)
    # The one-mask form is the multi form's row, slot by slot.
    for k in range(q):
        one = ops.cover_counts(convert.masks_from_numpy(vis, "cpu"),
                               convert.masks_from_numpy(act[:, k], "cpu"))
        np.testing.assert_array_equal(one.numpy(), want[k])


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("colors", [40, 64, 200])
def test_engine_marginal_counts_match_the_reference(colors, use_kernel):
    """`engine.marginal_counts` (one multi launch) ≡ the reference's
    ``marginal_counts_program`` (a map over the slots, through the Pallas
    kernel or the plain counts), for 8 slots with ragged exclusion sets,
    one empty slot and tail colour bits past ``colors``."""
    rs = np.random.default_rng(colors)
    b, v, w = 5, 384, -(-colors // 32)
    vis = _words(rs, (b, v, w))
    seeds = rs.integers(0, v, (8, 4))
    mask = rs.random((8, 4)) < 0.6
    mask[3] = False
    want = np.asarray(jengine._marginal_counts(
        jnp.asarray(vis), jnp.asarray(seeds), jnp.asarray(mask),
        num_colors=colors, use_kernel=use_kernel))
    got = tengine.marginal_counts(convert.masks_from_numpy(vis, "cpu"),
                                  torch.from_numpy(seeds),
                                  torch.from_numpy(mask), colors)
    assert got.shape == (8, v)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_marginal_answers_match_the_reference():
    """On the launcher's graph and pool: every slot of a full flush of
    marginal queries, and one query alone, equal the reference engine's
    answers."""
    args = tlaunch.parse_args(["--device", "cpu"])
    sj = jserve.SketchStore(jlaunch.build_graph(args),
                            jserve.PoolConfig(spec=JSpec(backend="dense")))
    st = tserve.SketchStore(tlaunch.build_graph(args),
                            tlaunch.build_config(args))
    sj.ensure(4)
    st.ensure(4)
    ej, et = jserve.QueryEngine(sj), tserve.QueryEngine(st)
    rs = np.random.default_rng(0)
    sets = [rs.integers(0, args.n, rs.integers(0, 6)).tolist()
            for _ in range(et.query_slots)]
    want = np.asarray(ej.marginal_padded(*jengine.pad_queries(
        sets, ej.query_slots, ej.max_seeds)))
    got = et.marginal_padded(*et.pad(sets))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and got.any()
    np.testing.assert_array_equal(et.marginal_gains(sets[0]),
                                  np.asarray(ej.marginal_gains(sets[0])))
