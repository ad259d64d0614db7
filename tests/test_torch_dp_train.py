"""Port ≡ reference for the data-parallel step's int8 gradient compression
(`optim.compress`, `train.dp_step`).

`quantize` is bit-identical to the reference's on the same arrays.
`compressed_psum` runs on a gloo world of 4 CPU ranks
(`torch_mesh_workers.dp_world`, each rank's gradient drawn from numpy by
its position) and is held against the reference's own ``compressed_psum``
under ``shard_map`` on 4 forced host devices in a subprocess
(``scripts/make_torch_golden.py --dp-worker``): the mean bit for bit (an
int32 sum of int8 values, one shared scale), every rank's residual
``g - q · scale`` within one float32 spacing of ``g`` (XLA contracts it
into a fused multiply-subtract, PyTorch rounds the product first; the
difference cancels to ~1e-2 from ``g`` ~ 4).
The reference's convergence check (``tests/test_dp_compression.py``: the
smoke llama, 25 steps, exact against compressed) runs on the same 4
ranks."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro.optim import compress as jcompress
from repro_torch.launch import accel
from repro_torch.optim import compress

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import make_torch_golden  # noqa: E402

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

JOB = dict(devices=4, seed=3, shapes={"w": [33, 7], "b": [5], "e": [64]},
           steps=25, batch=16)


@functools.lru_cache(maxsize=None)
def _world() -> list:
    return accel.spawn(workers.dp_world, JOB["devices"], args=(JOB,),
                       device="cpu", timeout_s=300)


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
@pytest.mark.parametrize("n", [1, 17, 1000])
def test_quantize_is_bit_identical(scale, n):
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(
        np.float32)
    q, s = compress.quantize(torch.from_numpy(x))
    wq, ws = jcompress.quantize(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert float(s) == float(ws)
    np.testing.assert_array_equal(compress.dequantize(q, s).numpy(),
                                  np.asarray(jcompress.dequantize(wq, ws)))


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32) * 3)
    q, scale = compress.quantize(x)
    err = (compress.dequantize(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_converges():
    """SGD + int8 compression + error feedback drives a quadratic to zero
    (the reference's test, on the port)."""
    w = torch.tensor([2.0, -1.5])
    err = torch.zeros_like(w)
    for _ in range(300):
        g = 2 * w
        q, scale = compress.quantize(g + err)
        g_hat = compress.dequantize(q, scale)
        err = (g + err) - g_hat
        w = w - 0.05 * g_hat
    assert float(w.abs().max()) < 1e-2


def test_compressed_psum_matches_the_reference_on_four_ranks():
    want = make_torch_golden.dp_reference_subprocess(
        {k: v for k, v in JOB.items() if k not in ("steps", "batch")})
    for r in _world():
        for k in JOB["shapes"]:
            np.testing.assert_array_equal(r["mean"][k],
                                          np.float32(want["mean"][k]))
            g = workers.dp_grads(JOB, r["rank"])[k]
            diff = np.abs(r["residual"][k]
                          - np.float32(want["residual"][k][r["rank"]]))
            assert (diff <= np.spacing(np.abs(g))).all(), k
    means = [r["mean"]["w"] for r in _world()]
    assert all(np.array_equal(m, means[0]) for m in means)


def test_compressed_dp_converges_like_exact():
    """The reference's convergence check, on 4 ranks of 4 sequences."""
    for r in _world():
        exact, comp = r["exact"], r["compressed"]
        assert comp[-1] < comp[0] - 0.4, "compressed run must learn"
        assert abs(comp[-1] - exact[-1]) < 0.25, (comp[-1], exact[-1])
        assert comp == _world()[0]["compressed"]    # the ranks agree
