"""The four flash-attention routes: which shapes take which, the
wrappers' refusals, and the decode route's split-K function on the CPU.

`repro_torch.kernels.flash_attention.route` picks ``wgmma`` (bf16 prefill
at head dim 64, 80, 96, 128 or 192), ``tf32x3`` (float32 prefill at those
head dims), ``decode`` (one query row) or ``simt`` (the rest) from a
call's shapes, and `route_bwd` the gradient's route the same way.  The
decode kernel splits the keys into chunks and merges float32 partials;
its plain version
`kernels.ref.flash_decode_splitk_ref` does the same (for any chunk
length, the kernel's own from `decode_split` among them) and is held here
against the reference's Pallas kernel in interpret mode and against
`ref.flash_attention_ref`, on inputs made with numpy from a seed, within
the float32 tolerance of `tests/test_torch_flash.py` (1e-5).  The kernels
themselves are held against these on the GPU (`tests/test_torch_cuda.py`,
``chip_smoke.py``)."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (B, Lq, Lk, H, KVH, D, causal, dtype) -> route: the LM main path's
# prefill and decode (bf16, llama3.2-3b at batch 4, prompt 2,048), the LM
# golden check's (float32, batch 2, prompt 64, 8 decode steps over a
# 72-slot cache), the smoke's kernel cases, maverick's, zamba2's (D 80) and
# phi-3-vision's (D 96).
BF16, F32 = torch.bfloat16, torch.float32
ROUTE_CASES = [
    ((4, 2048, 2048, 24, 8, 128, True, BF16), "wgmma"),
    ((4, 1, 2080, 24, 8, 128, True, BF16), "decode"),
    ((4, 32, 32, 24, 8, 128, True, BF16), "wgmma"),
    ((4, 1, 64, 24, 8, 128, True, BF16), "decode"),
    ((2, 64, 64, 24, 8, 128, True, F32), "tf32x3"),
    ((2, 1, 72, 24, 8, 128, True, F32), "decode"),
    ((4, 2048, 2048, 24, 8, 128, True, F32), "tf32x3"),
    ((2, 128, 128, 4, 4, 64, False, BF16), "wgmma"),
    ((2, 100, 100, 6, 2, 96, True, BF16), "wgmma"),
    ((1, 130, 190, 8, 1, 128, True, BF16), "wgmma"),
    ((1, 65, 129, 6, 2, 192, True, BF16), "wgmma"),
    ((1, 65, 129, 6, 2, 192, True, F32), "tf32x3"),
    ((3, 33, 33, 4, 4, 16, True, BF16), "simt"),
    ((2, 1, 77, 8, 1, 64, True, F32), "decode"),
    ((2, 200, 457, 6, 2, 64, True, BF16), "wgmma"),
    ((2, 200, 457, 6, 2, 64, True, F32), "tf32x3"),
    # maverick (H 40 over KVH 8, a group of 5): its main path and golden
    ((4, 2048, 2048, 40, 8, 128, True, BF16), "wgmma"),
    ((4, 1, 2080, 40, 8, 128, True, BF16), "decode"),
    ((2, 64, 64, 40, 8, 128, True, F32), "tf32x3"),
    ((2, 1, 72, 40, 8, 128, True, F32), "decode"),
    # zamba2's shared block (H = KVH 32, D 80) and phi-3-vision (D 96): the
    # bf16 main-path prefill on wgmma, the same in float32 (the goldens'
    # prefill) on tf32x3, and each decode
    ((4, 2048, 2048, 32, 32, 80, True, BF16), "wgmma"),
    ((4, 2048, 2048, 32, 32, 96, True, BF16), "wgmma"),
    ((4, 2048, 2048, 32, 32, 80, True, F32), "tf32x3"),
    ((4, 2048, 2048, 32, 32, 96, True, F32), "tf32x3"),
    ((2, 512, 512, 32, 32, 80, True, F32), "tf32x3"),
    ((2, 128, 128, 32, 32, 96, True, F32), "tf32x3"),
    ((4, 1, 2080, 32, 32, 80, True, BF16), "decode"),
    ((4, 1, 2080, 32, 32, 96, True, BF16), "decode"),
    # the smoke's wgmma cases at D 80 and 96 (ragged, GQA groups 3 and 8)
    ((1, 130, 190, 8, 1, 80, True, BF16), "wgmma"),
    ((1, 130, 190, 8, 1, 96, False, BF16), "wgmma"),
    ((2, 200, 457, 6, 2, 80, True, BF16), "wgmma"),
    # nemotron's head dim 192 (H 96 over KVH 8): the bf16 prefill on
    # wgmma, float32 on tf32x3; head dims no tensor-core route takes (16
    # and 32: the mesh goldens' smoke configs) stay on simt in either dtype
    ((4, 2048, 2048, 96, 8, 192, True, BF16), "wgmma"),
    ((1, 4096, 4096, 96, 8, 192, True, BF16), "wgmma"),
    ((1, 4096, 4096, 96, 8, 192, True, F32), "tf32x3"),
    ((3, 33, 33, 4, 4, 16, False, BF16), "simt"),
    ((3, 33, 33, 4, 4, 16, True, F32), "simt"),
    ((2, 64, 64, 4, 2, 32, True, F32), "simt"),
    ((2, 64, 64, 4, 2, 32, False, BF16), "simt"),
    ((1, 130, 130, 12, 1, 192, False, F32), "tf32x3"),
    ((2, 100, 140, 4, 4, 80, True, F32), "tf32x3"),
    ((2, 1, 300, 96, 8, 192, True, F32), "decode"),
]


@pytest.mark.parametrize("shape,want", ROUTE_CASES)
def test_route_by_shape(shape, want):
    b, lq, lk, h, kvh, d, causal, dtype = shape
    assert fa.route(dtype, b, lq, lk, h, kvh, d, causal) == want


# (dtype, L, D) -> the gradient's route: the forward's where that was a
# tensor-core route (wgmma in bf16, tf32x3 in float32, at D 64-192 and
# L > 1), simt otherwise (D 16 and 32, and L 1, whose forward is decode).
ROUTE_BWD_CASES = [
    ((BF16, 4096, 128), "wgmma"), ((BF16, 4096, 192), "wgmma"),
    ((F32, 4096, 128), "tf32x3"), ((F32, 4096, 192), "tf32x3"),
    ((F32, 2, 64), "tf32x3"), ((F32, 130, 80), "tf32x3"),
    ((F32, 257, 96), "tf32x3"), ((F32, 64, 16), "simt"),
    ((F32, 64, 32), "simt"), ((BF16, 64, 16), "simt"),
    ((F32, 1, 128), "simt"), ((BF16, 1, 192), "simt"),
]


@pytest.mark.parametrize("shape,want", ROUTE_BWD_CASES)
def test_route_bwd_by_shape(shape, want):
    dtype, L, d = shape
    assert fa.route_bwd(dtype, L, d) == want
    assert d in fa.bwd_head_dims(want)
    # A route that reads the forward's lse is the forward's own route.
    if want in fa.LSE_BWD_ROUTES:
        assert fa.route(dtype, 1, L, L, 8, 2, d, True) == want


def test_smoke_cases_run_every_route():
    """Every case the smoke's flash phase runs has the route this file's
    table gives it, and the cases cover all four routes."""
    cs = _smoke_module()
    table = {shape: want for shape, want in ROUTE_CASES}
    seen = set()
    for _, b, lq, lk, h, kvh, d, causal, _ in cs._flash_cases():
        for dtype in (F32, BF16):
            r = fa.route(dtype, b, lq, lk, h, kvh, d, causal)
            seen.add(r)
            key = (b, lq, lk, h, kvh, d, causal, dtype)
            if key in table:
                assert table[key] == r
    assert seen == set(fa.ROUTES)


def _inputs(seed, shapes):
    """float32 arrays of the given shapes, normal from ``seed``, as (jax,
    torch) pairs holding the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape, dtype=np.float32)
        out.append((jnp.asarray(a), torch.from_numpy(a)))
    return out


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("h,kvh", [(4, 4), (6, 2), (8, 1)])
@pytest.mark.parametrize("lk,block_k", [(77, 77), (150, 75)])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_splitk_matches_pallas_kernel(h, kvh, lk, block_k, where):
    """One query row over a ragged cache (GQA groups 1, 3 and 8) at
    kv_offset 0, mid-cache and Lk - 1, split into chunks of 13 keys (a
    length that divides neither cache), against the Pallas kernel fed K/V
    repeated per group and the reference's oracle."""
    off = {"first": 0, "mid": lk // 2, "last": lk - 1}[where]
    g = h // kvh
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        h * 100 + lk + off, [(1, h, 32), (lk, kvh, 32), (lk, kvh, 32)])
    got = tref.flash_decode_splitk_ref(qt[None], kt[None], vt[None],
                                       chunk=13, causal=True,
                                       kv_offset=off)[0]
    kr, vr = jnp.repeat(kj, g, axis=1), jnp.repeat(vj, g, axis=1)
    _close(got, jflash.flash_attention(qj, kr, vr, causal=True,
                                       kv_offset=off, block_k=block_k,
                                       interpret=True))
    _close(got, jref.flash_attention_ref(qj, kr, vr, causal=True,
                                         kv_offset=off))


@pytest.mark.parametrize("chunk", [77, 39, 16, 8, 6, 1, 100])
@pytest.mark.parametrize("kv_offset", [0, 20, 76])
@pytest.mark.parametrize("h,kvh", [(3, 3), (6, 2), (16, 2)])
def test_splitk_equals_plain_attention(chunk, kv_offset, h, kvh):
    """Any split of a 77-key cache gives the plain softmax: chunk lengths
    that do not divide 77, chunks with no visible key (at kv_offset 0
    every chunk after the first, at 20 most of them; with chunks of one
    key, 76 of 77), one chunk longer than the cache, GQA groups 1, 3 and
    8; batch 2."""
    rng = np.random.default_rng(chunk * 1000 + kv_offset + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 1, h, 32), (2, 77, kvh, 32), (2, 77, kvh, 32)))
    got = tref.flash_decode_splitk_ref(q, k, v, chunk=chunk, causal=True,
                                       kv_offset=kv_offset)
    want = tref.flash_attention_ref(q, k, v, causal=True,
                                    kv_offset=kv_offset)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_splitk_chunk_past_visible_keys_contributes_nothing():
    """A chunk with no visible key is (m, l) = (-inf, 0): appending keys
    past kv_offset, in chunks of their own, changes nothing — with any
    values there, even huge ones."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((1, 1, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    k[:, 20:] = 1e4
    v[:, 20:] = -1e4
    got = tref.flash_decode_splitk_ref(q, k, v, chunk=20, causal=True,
                                       kv_offset=19)
    want = tref.flash_attention_ref(q, k[:, :20], v[:, :20],
                                    causal=False)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_splitk_non_causal_and_several_rows():
    """Without ``causal`` every key takes part; with several query rows
    each row has its own visible range."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 5, 4, 16), (2, 33, 2, 16), (2, 33, 2, 16)))
    for causal in (True, False):
        torch.testing.assert_close(
            tref.flash_decode_splitk_ref(q, k, v, chunk=9, causal=causal,
                                         kv_offset=3),
            tref.flash_attention_ref(q, k, v, causal=causal, kv_offset=3),
            atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,kvh,h,n_vis,want", [
    (4, 8, 24, 2080, (128, 17)),    # the LM main path's decode: 544 CTAs
    (4, 8, 24, 2049, (128, 17)),
    (4, 8, 24, 33, (32, 2)),        # mix (a)'s first step
    (2, 8, 24, 72, (32, 3)),        # the LM golden check's last step
    (1, 1, 12, 300, (32, 10)),      # three head groups of four
    (1, 8, 8, 2080, (32, 65)),
    (1, 1, 1, 200_000, (384, 521)),
    (64, 8, 24, 2080, (1056, 2)),   # 512 groups nearly fill the card
])
def test_decode_split(b, kvh, h, n_vis, want):
    chunk, n = fa.decode_split(b, kvh, h, n_vis, 132)
    assert (chunk, n) == want
    assert (n - 1) * chunk < n_vis <= n * chunk     # no split past n_vis
    assert chunk % fa.SUB_BLOCK == 0 and n <= fa.MAX_CHUNKS
    groups = b * kvh * -(-(h // kvh) // fa.HEADS_PER_CTA)
    # About CTAS_PER_SM CTAs per SM: never more splits than that needs.
    assert groups * (n - 1) < fa.CTAS_PER_SM * 132


@pytest.mark.parametrize("causal,kv_offset,want", [
    (True, 0, 1), (True, 40, 41), (True, 500, 77), (False, 0, 77)])
def test_visible_keys(causal, kv_offset, want):
    assert fa.visible_keys(77, causal, kv_offset) == want


def test_cpu_decode_runs_the_plain_version_and_counts_nothing():
    """On CPU tensors ops.flash_attention is the plain version for every
    route's shapes, and no route's counter moves."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 1, 6, 32), (2, 50, 2, 32), (2, 50, 2, 32)))
    before = dict(tops.LAUNCHES)
    got = tops.flash_attention(q, k, v, causal=True, kv_offset=30)
    assert tops.LAUNCHES == before
    torch.testing.assert_close(got, tref.flash_attention_ref(
        q, k, v, causal=True, kv_offset=30), atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "offset", "shape"])
def test_wgmma_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The wgmma route takes bf16 at D 64, 80, 96, 128 or 192 only (not
    48); the checks run before any build or launch."""
    dt, d, off, kvh = torch.bfloat16, 128, 0, 2
    if bad == "dtype":
        dt = torch.float32
    elif bad == "head_dim":
        d = 48
    elif bad == "offset":
        off = -1
    else:
        kvh = 3
    q = torch.zeros((1, 8, 4, d), dtype=dt)
    kv = torch.zeros((1, 8, kvh, d), dtype=dt)
    with pytest.raises(ValueError):
        fa.flash_prefill_wgmma_cuda(q, kv, kv, causal=True, scale=0.1,
                                    kv_offset=off)


@pytest.mark.parametrize("bad", ["rows", "head_dim", "shape", "dtype",
                                 "offset"])
def test_decode_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The decode route takes one query row, float32 or bf16, D a multiple
    of 16 and K/V of q's batch and head dim; the checks run before any
    build or launch."""
    lq, dt, d, kv_b, off = 1, torch.float32, 64, 1, 0
    if bad == "rows":
        lq = 2
    elif bad == "head_dim":
        d = 72
    elif bad == "shape":
        kv_b = 2
    elif bad == "dtype":
        dt = torch.float16
    else:
        off = -2
    q = torch.zeros((1, lq, 4, d), dtype=dt)
    kv = torch.zeros((kv_b, 300, 2, d), dtype=dt)
    with pytest.raises(ValueError):
        fa.flash_decode_cuda(q, kv, kv, causal=True, scale=0.1,
                             kv_offset=off)


def _tf32x3_call(bad: str):
    """Tensors for the tf32x3 forward and backward wrappers, made wrong in
    one way: ``dtype`` (bf16), ``head_dim`` (16), ``aligned`` (q starting
    4 bytes into its storage), ``lse`` (a (B, H, L + 1) lse)."""
    dt, d, L = torch.float32, 64, 40
    if bad == "dtype":
        dt = torch.bfloat16
    elif bad == "head_dim":
        d = 16
    q = torch.zeros((1, L, 4, d), dtype=dt)
    if bad == "aligned":
        q = torch.zeros(q.numel() + 1, dtype=dt)[1:].view(q.shape)
    kv = torch.zeros((1, L, 2, d), dtype=dt)
    lse = torch.zeros((1, 4, L + (bad == "lse")), dtype=torch.float32)
    return q, kv, lse


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "aligned", "lse"])
def test_tf32x3_wrappers_refuse_what_the_kernels_do_not_take(bad):
    """The tf32x3 forward and each of its backward launches take float32
    at D 64, 80, 96, 128 or 192, 16-byte aligned, with a (B, H, L) lse;
    anything else is refused before any build or launch, on any device."""
    q, kv, lse = _tf32x3_call(bad)
    kw = dict(causal=True, scale=0.1)
    with pytest.raises(ValueError):
        fa.flash_prefill_tf32x3_cuda(q, kv, kv, kv_offset=0, lse=lse, **kw)
    with pytest.raises(ValueError):
        fa.flash_bwd_tf32x3_dq_cuda(q, kv, kv, q, q, lse, **kw)
    for fn in (fa.flash_bwd_tf32x3_dkdv_cuda, fa.flash_bwd_tf32x3_dv_cuda,
               fa.flash_bwd_tf32x3_dk_cuda):
        with pytest.raises(ValueError):
            fn(q, kv, kv, q, lse, lse, **kw)


def test_tf32x3_dkdv_wrappers_take_their_part_of_the_head_dims():
    """Below D 192 the fused dk/dv launch; at 192 dv and dk apart: each
    wrapper refuses the other form before any launch."""
    kw = dict(causal=True, scale=0.1)
    for d, refused in ((128, (fa.flash_bwd_tf32x3_dv_cuda,
                              fa.flash_bwd_tf32x3_dk_cuda)),
                       (192, (fa.flash_bwd_tf32x3_dkdv_cuda,))):
        q = torch.zeros((1, 40, 4, d))
        kv = torch.zeros((1, 40, 2, d))
        lse = torch.zeros((1, 4, 40))
        for fn in refused:
            with pytest.raises(ValueError, match="launch"):
                fn(q, kv, kv, q, lse, lse, **kw)


@pytest.mark.parametrize("d", [64, 128, 192])
def test_cpu_float32_prefill_and_gradient_run_the_plain_version(d):
    """A float32 call at a tf32x3 head dim on CPU tensors runs the plain
    version, forward (with its lse) and backward, and counts nothing."""
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   for s in ((2, 40, 6, d), (2, 40, 2, d), (2, 40, 2, d),
                             (2, 40, 6, d)))
    assert fa.route_bwd(q.dtype, 40, d) == "tf32x3"
    before = dict(tops.LAUNCHES)
    o, lse = tops.flash_attention_fwd(q, k, v, causal=True)
    got = tops.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    assert tops.LAUNCHES == before
    torch.testing.assert_close(o, tref.flash_attention_ref(q, k, v),
                               atol=0, rtol=0)
    torch.testing.assert_close(lse, tref.flash_attention_lse_ref(q, k),
                               atol=0, rtol=0)
    want = tref.flash_attention_bwd_ref(q, k, v, o, do, causal=True,
                                        lse=lse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="log-sum-exp"):
        tops.flash_attention_bwd(q, k, v, o, do, causal=True)
