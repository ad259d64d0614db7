"""The flash-attention gradient: its plain version, the autograd rule of
`kernels.ops.flash_attention`, and the attention layer's gradient against
the reference's.

`ref.flash_attention_bwd_ref` (the backward kernel's plain version) and
the gradient that `ops.flash_attention` gives on CPU tensors are held
against ``torch.autograd.grad`` through `ref.flash_attention_ref`, in
float32 at atol 1e-5 (the two differ by the order of float32 sums only),
over head dims 16/32/64, GQA groups 1/2/4, lengths 32/40/48 (40 is not a
multiple of the kernel's 64-row tiles, nor of 16) and causal or not.  The
port's `attention.gqa_forward` is differentiated against ``jax.vjp`` of
the reference's (its jnp blocked scan) at the smoke config, on the same
weights and inputs from numpy, at 1e-5, with the backward's plain version
in both forms: the softmax one (the ``simt`` route's) and the one reading
the forward's log-sum-exp (the ``wgmma`` and ``tf32x3`` routes', at atol
2e-5).  The
CUDA kernels themselves are held against the plain version on the card
(the ``cuda``-marked tests here and in ``test_torch_flash_bwd_wgmma.py``,
and ``chip_smoke.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

KVH = 2


def _qkv(seed, L, group, d, dtype=torch.float32, b=2):
    g = torch.Generator().manual_seed(seed)
    h = KVH * group
    q = torch.randn((b, L, h, d), generator=g)
    k = torch.randn((b, L, KVH, d), generator=g)
    v = torch.randn((b, L, KVH, d), generator=g)
    do = torch.randn((b, L, h, d), generator=g)
    return [t.to(dtype) for t in (q, k, v, do)]


def _autograd(q, k, v, do, causal):
    """(o, (dq, dk, dv)) by autograd through the plain forward."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, causal=causal)
    return o.detach(), torch.autograd.grad(o, leaves, do)


CASES = [dict(d=d, group=g, L=L, causal=c) for d in (16, 32, 64)
         for g in (1, 2, 4) for L in (32, 40, 48) for c in (True, False)]


def _id(case):
    return (f"d{case['d']}-g{case['group']}-L{case['L']}-"
            f"{'causal' if case['causal'] else 'full'}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_backward_matches_autograd(case):
    q, k, v, do = _qkv(case["L"] + case["d"], case["L"], case["group"],
                       case["d"])
    o, want = _autograd(q, k, v, do, case["causal"])
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=case["causal"])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ops_gradient_matches_autograd(case):
    q, k, v, do = _qkv(case["L"] * case["group"], case["L"], case["group"],
                       case["d"])
    _, want = _autograd(q, k, v, do, case["causal"])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(*leaves, causal=case["causal"])
    got = torch.autograd.grad(out, leaves, do)
    assert ops.LAUNCHES == before            # the CPU launches no kernel
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)


def test_bf16_plain_backward_is_the_float32_math_rounded():
    """bf16 inputs: the plain version computes in float32 and rounds only
    its results to bf16."""
    q, k, v, do = _qkv(7, 40, 2, 32, torch.bfloat16)
    o = ref.flash_attention_ref(q, k, v, causal=True)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), do.float(), causal=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b.to(torch.bfloat16), atol=0, rtol=0)


def test_gradient_needs_a_square_call_at_offset_zero():
    q, k, v, _ = _qkv(0, 32, 1, 16)
    q.requires_grad_()
    with pytest.raises(ValueError, match="kv_offset 0"):
        ops.flash_attention(q, k, v, causal=True, kv_offset=3)
    with pytest.raises(ValueError, match="Lq == Lk"):
        ops.flash_attention(q[:, :16], k, v, causal=True)
    with torch.no_grad():                    # no gradient: any offset
        ops.flash_attention(q[:, :16], k, v, causal=True, kv_offset=16)


@pytest.mark.parametrize("route", ["simt", "wgmma", "tf32x3"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("L", [16, 48])
def test_gqa_forward_gradient_matches_jax_vjp(bias, L, route, monkeypatch):
    """The attention layer's gradient in every weight and its input, the
    reference differentiating its blocked scan (three 16-row query blocks
    at L 48), the port through the flash autograd rule; with ``route``
    "wgmma" or "tf32x3" the rule takes that route's plain version (the
    forward's log-sum-exp saved and read; float32, so no rounding of P or
    dS).  That
    form's P = exp(s - lse) inherits the float32 rounding of lse (half an
    ulp, ~2e-6 at |lse| ~ 30), which the softmax form does not have; its
    gradients sit ~4e-6 from the softmax form's, so its atol is 2e-5
    where the softmax form keeps 1e-5."""
    monkeypatch.setattr(fa, "route_bwd", lambda *shape: route)
    atol = 1e-5 if route == "simt" else 2e-5
    kw = dict(num_patches=0, num_kv_heads=2, qkv_bias=bias)
    jc = dataclasses.replace(jregistry.smoke("llama3.2-3b"), **kw)
    tc = dataclasses.replace(registry.smoke("llama3.2-3b"), **kw)
    d, h, kvh, hd = tc.d_model, tc.num_heads, tc.num_kv_heads, tc.head_dim
    rng = np.random.default_rng(L + bias)

    def normal(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"wq": normal((d, h, hd), d ** -0.5),
         "wk": normal((d, kvh, hd), d ** -0.5),
         "wv": normal((d, kvh, hd), d ** -0.5),
         "wo": normal((h, hd, d), (h * hd) ** -0.5)}
    if bias:
        p.update(bq=normal((h, hd)), bk=normal((kvh, hd)),
                 bv=normal((kvh, hd)))
    x = normal((2, L, d))
    cot = normal((2, L, d))
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(L), (2, L)))

    def jfwd(jp, jx):
        return jattn.gqa_forward(jp, jx, jnp.asarray(pos), jc)[0]

    want_out, vjp = jax.vjp(jfwd, {k: jnp.asarray(a) for k, a in p.items()},
                            jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))

    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = attention.gqa_forward(tp, tx, torch.from_numpy(pos), tc)
    names = sorted(tp)
    grads = torch.autograd.grad(out, [tp[n] for n in names] + [tx],
                                torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=atol, rtol=1e-5)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[n]),
                                   atol=atol, rtol=1e-5, err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want_x),
                               atol=atol, rtol=1e-5)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.float32, 128),
                                     (torch.float32, 192),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernel_equals_plain(cuda, dtype, d, causal):
    """Every launch of the route `route_bwd` picks (float32: ``simt`` at D
    16, ``tf32x3`` at 128 and 192, three at D 192: dq, dv, dk, reading the
    forward's log-sum-exp; bf16 at D 64 and 96: ``wgmma``, reading it too)
    against the plain version of that route at
    a ragged length (130), GQA group 3: float32 at 1e-4, bf16 at 2e-2
    (both sides round their float32 results to bf16)."""
    q, k, v, do = (t.to(cuda) for t in _qkv(d, 130, 3, d, dtype))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    before = ops.LAUNCHES["flash_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_bwd"] == before + fa.bwd_launches(dtype, 130,
                                                                 d)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       lse=lse)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_backward_kernel_refuses_head_dim_192(cuda):
    """At D 192 the simt backward's fused dk/dv launch is refused (its
    shared memory would pass a block's 232,448 bytes: dv and dk take a
    launch each, `flash_bwd_dv_cuda` and `flash_bwd_dk_cuda`), and a head
    dim no backward route takes (48) is refused before any launch."""
    q, k, v, do = (t.to(cuda) for t in _qkv(0, 64, 1, 192, torch.float32))
    stats = fa.flash_bwd_dq_cuda(q, k, v, q, do, causal=True, scale=0.1)[1]
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="two launches"):
        fa.flash_bwd_dkdv_cuda(q, k, v, do, stats, causal=True, scale=0.1)
    q, k, v, do = (t.to(cuda) for t in _qkv(0, 64, 1, 48, torch.float32))
    with pytest.raises(ValueError, match="D in"):
        ops.flash_attention_bwd(q, k, v, q, do, causal=True)
    assert ops.LAUNCHES == before
