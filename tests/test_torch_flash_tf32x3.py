"""The numerics of the ``tf32x3`` route (float32 flash attention on the
tensor cores, every product three TF32 passes), on the CPU.

`kernels.ref.tf32_split` is the kernels' split of a float32 value into a
TF32 hi (``cvt.rna.tf32.f32``: to nearest, ties away from zero, the low
13 mantissa bits cleared) and a TF32 lo; `ref.tf32x3_matmul` takes a
product as the kernels take it (lo·hi, hi·lo, hi·hi a slice of 8), and
`ref.flash_attention_tf32x3_ref` / `ref.flash_attention_bwd_tf32x3_ref`
are the forward and the backward with every product taken so.  Held here
against the reference, on inputs made with numpy from a seed: the
forward against its Pallas kernel in interpret mode, the gradient against
``jax.vjp`` of its blocked online softmax (``repro.models.attention``), at
L 130 and 257, D 64, 128 and 192, GQA groups 1 and 3, causal and not,
within the limits ``chip_smoke.py`` holds the kernels to on the card:
``F32_TOL`` on the output and ``BWD_F32_TOL`` on the gradients (relative
to the largest magnitude at D 192, as there).  A single TF32 pass at the
same inputs lies outside ``F32_TOL``: the check tells the two apart.
Nothing on the port's paths calls these emulations."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.kernels import ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_limits():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.F32_TOL, mod.BWD_F32_TOL


F32_TOL, BWD_F32_TOL = _smoke_limits()


@pytest.mark.parametrize("scale_exp", [-30, -3, 0, 7, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_clears_13_bits_and_keeps_the_value(scale_exp, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        4096).astype(np.float32) * np.float32(2.0 ** scale_exp))
    hi, lo = ref.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    # hi alone is x to TF32's half ulp, 2^-11 relative.
    assert bool(((hi.double() - x.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())


def test_tf32_split_rounds_ties_away_from_zero():
    """A value halfway between two TF32 values (low 13 bits 0x1000) rounds
    away from zero, in either sign; one bit under halfway rounds toward
    zero."""
    bits = torch.tensor([0x3F801000, -0x407FF000, 0x3F800FFF],
                        dtype=torch.int32)
    x = bits.view(torch.float32)
    hi, lo = ref.tf32_split(x)
    assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]
    torch.testing.assert_close(hi + lo, x, atol=0, rtol=2 ** -21)


def test_tf32x3_matmul_three_passes_and_one():
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 70, 203), (2, 203, 40)))
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    three = float((ref.tf32x3_matmul(a, b).double() - exact).abs().max())
    one = float((ref.tf32x3_matmul(a, b, 1).double() - exact).abs().max())
    plain = float(((a @ b).double() - exact).abs().max())
    assert three <= 4 * plain + 1e-6 * scale
    assert one > 100 * three


def _inputs(seed, L, h, kvh, d):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, L, h, d), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, L, kvh, d), dtype=np.float32)
            for _ in range(2))
    return q, k, v, do


def _pallas(q, k, v, causal):
    """The reference's Pallas kernel (interpret mode, one block) on the
    unbatched layout, K/V repeated for each group's query heads."""
    g = q.shape[2] // k.shape[2]
    L = q.shape[1]
    out = jflash.flash_attention(
        jnp.asarray(q[0]), jnp.repeat(jnp.asarray(k[0]), g, axis=1),
        jnp.repeat(jnp.asarray(v[0]), g, axis=1), causal=causal, block_q=L,
        block_k=L, interpret=True)
    return np.asarray(out)[None]


CASES = [pytest.param(L, d, g, causal, id=f"L{L}-D{d}-G{g}-"
                      + ("causal" if causal else "full"))
         for L in (130, 257) for d in (64, 128, 192) for g in (1, 3)
         for causal in (True, False)]


@pytest.mark.parametrize("L,d,g,causal", CASES)
def test_tf32x3_forward_holds_f32_tol_against_the_pallas_kernel(L, d, g,
                                                                causal):
    q, k, v, _ = _inputs(L + d + g, L, g, 1, d)
    got, lse = ref.flash_attention_tf32x3_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    want = _pallas(q, k, v, causal)
    assert float(np.abs(got.numpy() - want).max()) <= F32_TOL
    want_lse = ref.flash_attention_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), causal=causal)
    torch.testing.assert_close(lse, want_lse, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("L,d,g,causal", CASES)
def test_tf32x3_backward_holds_bwd_f32_tol_against_jax_vjp(L, d, g, causal):
    """The emulated backward (P from the emulated forward's lse) against
    ``jax.vjp`` of the reference's blocked online softmax; non-causal as
    its scan with a key offset past every key."""
    q, k, v, do = _inputs(L * 7 + d + g, L, g, 1, d)
    scale = d ** -0.5

    def jattention(jq, jk, jv):
        out = jattn._blocked_attn(jq.reshape(1, L, 1, g, d),
                                  lambda j: (jk, jv), 1, L, 0, scale,
                                  0 if causal else L)
        return out.reshape(1, L, g, d)

    _, vjp = jax.vjp(jattention, q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_tf32x3_ref(tq, tk, tv, causal=causal)
    got = ref.flash_attention_bwd_tf32x3_ref(tq, tk, tv, o, tdo, lse,
                                             causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        err = float(np.abs(a.numpy() - w).max())
        if d == 192:       # the card's limit there: relative to the largest
            err /= float(np.abs(w).max())
        assert err <= BWD_F32_TOL, (name, err)


@pytest.mark.parametrize("d", [128, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_single_tf32_pass_lies_outside_f32_tol(d, causal):
    """The control: the same forward with each product one TF32 pass
    misses F32_TOL by far (about 1e-3), so the check above tells three
    passes from one."""
    L, g = 257, 3
    q, k, v, _ = _inputs(L + d + g, L, g, 1, d)
    got = ref.flash_attention_tf32x3_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, passes=1)[0]
    err = float(np.abs(got.numpy() - _pallas(q, k, v, causal)).max())
    assert err > 10 * F32_TOL
