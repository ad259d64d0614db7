"""The flash-attention gradient's ``wgmma`` route: `route_bwd`, the
log-sum-exp the forward writes for it and its plain version, the
backward's plain version reading that log-sum-exp, and the autograd rule
that carries it from the forward to the backward.

On the CPU: `ref.flash_attention_lse_ref` against a float64 numpy
log-sum-exp of the same scores (1e-5); `ref.flash_attention_bwd_ref`
with ``lse`` against the softmax form in float32 (1e-5: with float32
inputs its rounding of P and dS is the identity) and within bf16's
rounding of it in bf16 (2e-2).  On the card (``cuda``-marked, skipped
here): the kernel against that plain version at ragged lengths and GQA
groups (atol = rtol = 2e-2 and a relative RMS of 6e-3, ``chip_smoke.py``'s
bf16 limits), the forward's ``lse`` against its plain version (1e-4), and
the same bits from two runs."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

BF16_TOL, BF16_RMS_TOL, LSE_TOL = 2e-2, 6e-3, 1e-4


def _qkv(seed, L, h, kvh, d, dtype=torch.float32, b=2, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, L, h, d), generator=g) for _ in range(2))
    k, v = (torch.randn((b, L, kvh, d), generator=g) for _ in range(2))
    return [t.to(device, dtype) for t in (q, k, v, do)]


def test_route_bwd_picks_by_shape():
    bf16, f32 = torch.bfloat16, torch.float32
    for d in fa.WGMMA_HEAD_DIMS:
        assert fa.route_bwd(bf16, 4096, d) == "wgmma"
        assert fa.route_bwd(bf16, 2, d) == "wgmma"
        assert fa.route_bwd(bf16, 1, d) == "simt"      # forward: decode
        assert fa.route_bwd(f32, 4096, d) == "tf32x3"
        assert fa.route_bwd(f32, 1, d) == "simt"
    for d in (16, 32):
        assert fa.route_bwd(bf16, 4096, d) == "simt"
        assert fa.route_bwd(f32, 4096, d) == "simt"
    assert set(fa.BWD_ROUTES) == {"wgmma", "tf32x3", "simt"}


@pytest.mark.parametrize("causal,kv_offset", [(True, 0), (False, 0),
                                              (True, 7)])
def test_lse_plain_version_is_the_float64_logsumexp(causal, kv_offset):
    q, k, _, _ = _qkv(3, 40, 6, 2, 32)
    lk = 40
    q = q[:, :25]
    scale = 32 ** -0.5
    got = ref.flash_attention_lse_ref(q, k, causal=causal, scale=scale,
                                      kv_offset=kv_offset)
    qn, kn = q.double().numpy(), k.double().numpy()
    kn = np.repeat(kn, 3, axis=2)                          # GQA group 3
    s = np.einsum("bqhd,bkhd->bhqk", qn * scale, kn)
    if causal:
        qp = np.arange(25)[:, None] + kv_offset
        s = np.where(np.arange(lk)[None, :] > qp, -np.inf, s)
    top = s.max(-1, keepdims=True)
    want = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    assert got.dtype == torch.float32 and got.shape == (2, 6, 25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,h,kvh,L", [(64, 4, 4, 40), (80, 6, 2, 33),
                                       (128, 8, 1, 48)])
def test_plain_backward_with_lse_equals_the_softmax_form(d, h, kvh, L,
                                                          causal):
    q, k, v, do = _qkv(d + L, L, h, kvh, d)
    o = ref.flash_attention_ref(q, k, v, causal=causal)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, lse=lse)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)
    # bf16: P and dS rounded before their products, within bf16's rounding.
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    ob = ref.flash_attention_ref(qb, kb, vb, causal=causal)
    lb = ref.flash_attention_lse_ref(qb, kb, causal=causal)
    got = ref.flash_attention_bwd_ref(qb, kb, vb, ob, dob, causal=causal,
                                      lse=lb)
    want = ref.flash_attention_bwd_ref(qb, kb, vb, ob, dob, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL, msg=name)


def test_autograd_rule_carries_the_lse_on_the_wgmma_route():
    """bf16 at D 64 on the CPU: the forward saves its log-sum-exp and the
    backward is the plain version reading it; a direct backward call on
    that route without one raises, as on the card."""
    q, k, v, do = _qkv(5, 40, 4, 2, 64, torch.bfloat16)
    assert fa.route_bwd(q.dtype, 40, 64) == "wgmma"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    torch.testing.assert_close(lse, ref.flash_attention_lse_ref(q, k),
                               atol=0, rtol=0)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True, lse=lse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="log-sum-exp"):
        ops.flash_attention_bwd(q, k, v, o, do, causal=True)
    assert ops.flash_attention_fwd(q[..., :32].float(), k[..., :32].float(),
                                   v[..., :32].float())[1] \
        is None                                           # simt: no lse


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _close_bf16(got, want, what):
    diff = got.float() - want.float()
    assert bool((diff.abs() <= BF16_TOL + BF16_TOL
                 * want.float().abs()).all()), what
    rrms = float(diff.norm() / want.float().norm().clamp_min(1e-30))
    assert rrms <= BF16_RMS_TOL, (what, rrms)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,h,kvh,L", [(64, 4, 4, 130), (80, 6, 2, 257),
                                       (96, 10, 2, 130), (128, 8, 1, 257),
                                       (192, 12, 1, 257)])
def test_wgmma_backward_kernel_equals_plain(cuda, d, h, kvh, L, causal):
    q, k, v, do = _qkv(d, L, h, kvh, d, torch.bfloat16, device=cuda)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    n = fa.bwd_launches(q.dtype, L, d)                  # 3 at D 192
    assert ops.LAUNCHES["flash_bwd_wgmma"] == before["flash_bwd_wgmma"] + n
    assert ops.LAUNCHES["flash_bwd_simt"] == before["flash_bwd_simt"]
    assert ops.LAUNCHES["flash_bwd"] == before["flash_bwd"] + n
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       lse=lse)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_bf16(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_forward_lse_equals_plain(cuda, d):
    q, k, v, _ = _qkv(d, 257, 6, 2, d, torch.bfloat16, device=cuda)
    for causal in (True, False):
        _, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        want = ref.flash_attention_lse_ref(q, k, causal=causal)
        torch.testing.assert_close(lse, want, atol=LSE_TOL, rtol=0)


@pytest.mark.cuda
def test_wgmma_backward_gives_the_same_bits_twice(cuda):
    q, k, v, do = _qkv(1, 1024, 24, 8, 128, torch.bfloat16, b=1,
                       device=cuda)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    a = ops.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    b = ops.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
