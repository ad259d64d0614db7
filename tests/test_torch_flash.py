"""Port ≡ reference for the flash-attention kernel's plain version.

On CPU tensors `repro_torch.kernels.ops.flash_attention` runs the plain
PyTorch version (`kernels.ref.flash_attention_ref`); here it is held
against the reference's Pallas kernel in interpret mode and against the
reference's own oracle (``repro.kernels.ref.flash_attention_ref``), on
inputs made with numpy from a seed.  Tolerances are those of the
reference's kernel test: 1e-5 in float32, 2e-2 in bfloat16 (compared in
float32).  The CUDA kernel is held against the same plain version on the
GPU (`tests/test_torch_cuda.py`, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_cuda

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    """Arrays of the given shapes, normal from ``seed``, as (jax, torch)
    pairs holding the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                        getattr(jnp, dtype))
        t = torch.from_numpy(np.array(j, np.float32)).to(
            getattr(torch, dtype))
        out.append((j, t))
    return out


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("L,H,D", [(128, 2, 64), (256, 4, 128), (384, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel_and_oracle(L, H, D, dtype, causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(L + H, [(L, H, D)] * 3, dtype)
    got = tops.flash_attention(qt, kt, vt, causal=causal)
    assert got.shape == (L, H, D) and got.dtype == qt.dtype
    kern = jflash.flash_attention(qj, kj, vj, causal=causal, block_q=128,
                                  block_k=128, interpret=True)
    _close(got, kern, TOL[dtype])
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=causal),
           TOL[dtype])


def test_decode_offset_matches_pallas_kernel():
    """128 new queries against a 512 cache at kv_offset 384."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        0, [(128, 2, 64), (512, 2, 64), (512, 2, 64)], "float32")
    got = tops.flash_attention(qt, kt, vt, causal=True, kv_offset=384)
    _close(got, jflash.flash_attention(qj, kj, vj, causal=True,
                                       kv_offset=384, interpret=True), 1e-5)
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=True,
                                         kv_offset=384), 1e-5)


@pytest.mark.parametrize("kv_offset", [0, 5, 76])
def test_single_query_decode_masks_keys_after_offset(kv_offset):
    """Lq = 1 over a ragged 77-key cache: keys after kv_offset take no
    part (the decode mode the LM path uses)."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        kv_offset, [(1, 3, 32), (77, 3, 32), (77, 3, 32)], "float32")
    got = tops.flash_attention(qt, kt, vt, causal=True, kv_offset=kv_offset)
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=True,
                                         kv_offset=kv_offset), 1e-5)
    n = kv_offset + 1
    _close(got, jref.flash_attention_ref(qj, kj[:n], vj[:n], causal=False),
           1e-5)


@pytest.mark.parametrize("H,KVH", [(4, 2), (6, 2), (8, 1), (10, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_reads_kv_head_h_over_group(H, KVH, causal):
    """Query head h reads KV head h // (H // KVH): equal to the Pallas
    kernel fed K/V repeated per group (jnp.repeat on the head axis)."""
    g = H // KVH
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        H * 10 + KVH, [(128, H, 64), (128, KVH, 64), (128, KVH, 64)],
        "float32")
    got = tops.flash_attention(qt, kt, vt, causal=causal)
    kern = jflash.flash_attention(qj, jnp.repeat(kj, g, axis=1),
                                  jnp.repeat(vj, g, axis=1), causal=causal,
                                  interpret=True)
    _close(got, kern, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_length(dtype):
    """A length that is no multiple of any block: 100 queries over 100
    keys (one Pallas block of 100 rows)."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(5, [(100, 2, 48)] * 3, dtype)
    got = tops.flash_attention(qt, kt, vt, causal=True)
    _close(got, jflash.flash_attention(qj, kj, vj, causal=True,
                                       interpret=True), TOL[dtype])
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=True),
           TOL[dtype])


def test_batched_layout_is_per_batch_attention():
    """(B, L, H, D) equals each batch row through the unbatched layout;
    the plain version and the ops wrapper agree, and a CPU call counts no
    kernel launch."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((3, 40, 4, 32), (3, 56, 2, 32), (3, 56, 2, 32)))
    before = tops.LAUNCHES["flash_attention"]
    got = tops.flash_attention(q, k, v, causal=True, kv_offset=16)
    assert tops.LAUNCHES["flash_attention"] == before
    torch.testing.assert_close(got, tref.flash_attention_ref(
        q, k, v, causal=True, kv_offset=16), atol=0, rtol=0)
    for b in range(3):
        torch.testing.assert_close(
            got[b], tops.flash_attention(q[b], k[b], v[b], causal=True,
                                         kv_offset=16), atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad", ["head_dim", "groups", "offset", "dtype"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper's checks run before any build or launch."""
    d, kvh, off, dt = 64, 2, 0, torch.float32
    if bad == "head_dim":
        d = 24
    elif bad == "groups":
        kvh = 3
    elif bad == "offset":
        off = -1
    else:
        dt = torch.float16
    q = torch.zeros((1, 8, 4, d), dtype=dt)
    kv = torch.zeros((1, 8, kvh, d), dtype=dt)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, kv, kv, causal=True, scale=0.125,
                             kv_offset=off)
