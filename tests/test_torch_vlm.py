"""Port ≡ reference for phi-3-vision's patch embeddings: the projection
``patch_proj`` (PATCH_EMBED_DIM, d), the prefix it prepends to the token
embeddings, positions over both, and prefill plus decode after it.

Weights are `models/init.py::numpy_params` of the smoke config (4 patches
of 1,024, float32), handed to the reference as its tree and to the port
through `convert.lm_params_from_jax`; patch embeddings are
`numpy_patch_embeds` (normal, σ 0.3, as the reference's data pipeline
draws them), tokens numpy integers from a seed.  The prompt is 28 tokens
after the 4 patches: 32 positions, two of the smoke config's 16-row query
blocks.  Tolerances: 1e-5 for float32 logits (the reference's own LM
tests' limit for a whole smoke model, `test_torch_lm.py`), greedy tokens
exactly equal; in bf16 the embeddings within one bf16 step (atol = rtol
= 1e-2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import decode as jdecode
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import decode, init, model
from repro_torch.serve import engine

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ARCH = "phi-3-vision-4.2b"
TOL = 1e-5
B, TOKENS, STEPS = 2, 28, 4


def _cfgs(**kw):
    """(reference config, port config): the smoke config, ``kw`` replaced."""
    return (dataclasses.replace(jregistry.smoke(ARCH), **kw),
            dataclasses.replace(registry.smoke(ARCH), **kw))


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _weights(tc, seed=0):
    """(reference tree as jax arrays, the port's `LM`) on one numpy draw,
    both in the config's dtype (phi has no float32-only leaf)."""
    tree = init.numpy_params(tc, seed)
    tparams = convert.lm_params_from_jax(tree, tc, device="cpu")
    dt = getattr(jnp, tc.dtype)
    return jax.tree.map(lambda a: jnp.asarray(a, dt), tree), tparams


def _batch(tc, seed=1):
    """(tokens (B, TOKENS), patch embeddings (B, P, 1024)) as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, tc.vocab_size, (B, TOKENS)),
            init.numpy_patch_embeds(tc, seed, B))


def test_numpy_params_draw_the_reference_tree_with_patch_proj():
    """The tree has the reference's structure and shapes, ``patch_proj``
    (1024, d) among them at a fan-in scale, and the port's `LM` holds it
    exactly; without patches there is none."""
    jc, tc = _cfgs()
    tree = init.numpy_params(tc, 0)
    want = jmodel.param_shapes(jc)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert got.shape == ref.shape and got.dtype == np.float32
    assert tree["patch_proj"].shape == (model.PATCH_EMBED_DIM, tc.d_model)
    assert abs(tree["patch_proj"].std() * model.PATCH_EMBED_DIM ** 0.5
               - 1) < 0.05
    params = convert.lm_params_from_jax(tree, tc, device="cpu")
    np.testing.assert_array_equal(params.patch_proj.numpy(),
                                  tree["patch_proj"])
    _, plain = _cfgs(num_patches=0)
    assert "patch_proj" not in init.numpy_params(plain, 0)
    assert convert.lm_params_from_jax(init.numpy_params(plain, 0), plain,
                                      device="cpu").patch_proj is None


def test_init_params_draws_patch_proj_after_the_unembedding():
    """The port's seeded init holds ``patch_proj`` (1024, d) in the
    config's dtype; drawn after ``unembed``, it leaves the embedding and
    unembedding as a config without patches draws them."""
    _, tc = _cfgs(dtype="bfloat16")
    params = model.init_params(tc, seed=5, device="cpu")
    assert params.patch_proj.shape == (model.PATCH_EMBED_DIM, tc.d_model)
    assert params.patch_proj.dtype == torch.bfloat16
    plain = model.init_params(dataclasses.replace(tc, num_patches=0),
                              seed=5, device="cpu")
    assert plain.patch_proj is None
    assert torch.equal(params.embedding, plain.embedding)
    assert torch.equal(params.unembed, plain.unembed)
    assert not torch.equal(params.layers[0].attn["wq"],
                           plain.layers[0].attn["wq"])


def test_forward_with_patches_equals_the_reference():
    """Logits over the 4 patch positions and the 28 tokens, and positions
    running over both, within 1e-5 of ``repro.models.model.forward``."""
    jc, tc = _cfgs()
    jparams, tparams = _weights(tc)
    tokens, patches = _batch(tc)
    want, _, _ = jmodel.forward(jparams, jc, {
        "tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)})
    batch = {"tokens": torch.from_numpy(tokens),
             "patch_embeds": torch.from_numpy(patches)}
    got, _, _ = model.forward(tparams, tc, batch)
    assert got.shape == (B, tc.num_patches + TOKENS, tc.vocab_size)
    _close(got, want)
    _, positions = model.embed_inputs(tparams, tc, batch)
    assert torch.equal(positions, torch.arange(
        tc.num_patches + TOKENS).expand(B, -1))


def test_prefill_and_greedy_decode_with_patches_equal_the_reference():
    """``engine.prefill`` of patches and tokens, then 4 greedy
    ``decode_step``s at ``cur_len`` = P + tokens + i: every step's logits
    within 1e-5 of the reference's and every greedy token equal."""
    jc, tc = _cfgs()
    jparams, tparams = _weights(tc)
    tokens, patches = _batch(tc)
    L = tc.num_patches + TOKENS
    max_len = L + STEPS
    wl, wc, wlen = jengine.prefill(jparams, jc, {
        "tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)},
        max_len)
    gl, gc, glen = engine.prefill(tparams, tc, {
        "tokens": torch.from_numpy(tokens),
        "patch_embeds": torch.from_numpy(patches)}, max_len)
    assert glen == wlen == L
    assert gc[0]["k"].shape == (B, max_len, tc.num_kv_heads, tc.head_dim)
    _close(gl, wl)
    step = jax.jit(lambda p, c, t, n: jdecode.decode_step(p, jc, c, t, n))
    for i in range(STEPS):
        wtok = np.asarray(wl[:, -1]).argmax(-1)[:, None]
        gtok = gl[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(gtok.numpy(), wtok)
        wl, wc = step(jparams, wc, jnp.asarray(wtok), jnp.int32(L + i))
        gl, gc = decode.decode_step(tparams, tc, gc, gtok, L + i)
        _close(gl, wl)


def test_patched_config_without_patch_embeds_embeds_tokens_only():
    """A batch with no ``patch_embeds`` gets no prefix, as the reference's
    ``"patch_embeds" in batch`` gate gives: the patched config's logits
    equal those of ``num_patches=0`` on the same weights, and the
    reference's (32 tokens: two query blocks without a prefix)."""
    jc, tc = _cfgs()
    jparams, tparams = _weights(tc)
    L = tc.num_patches + TOKENS
    tokens = np.random.default_rng(1).integers(0, tc.vocab_size, (B, L))
    batch = {"tokens": torch.from_numpy(tokens)}
    got, _, _ = model.forward(tparams, tc, batch)
    plain, _, _ = model.forward(tparams, dataclasses.replace(
        tc, num_patches=0), batch)
    assert got.shape == (B, L, tc.vocab_size)
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    want, _, _ = jmodel.forward(jparams, jc, {"tokens": jnp.asarray(tokens)})
    _close(got, want)


def test_bf16_patch_projection_is_taken_in_float32_then_cast():
    """In bf16, float32 patches times the bf16 ``patch_proj`` is a float32
    product (jnp's promotion) cast to bf16 after: the embedded prefix and
    tokens within one bf16 step of the reference's, and closer to the
    float32 product than a product taken in bf16 would be."""
    jc, tc = _cfgs(dtype="bfloat16")
    jparams, tparams = _weights(tc)
    tokens, patches = _batch(tc)
    wh, wpos = jmodel.embed_inputs(jparams, jc, {
        "tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)})
    pe = torch.from_numpy(patches)
    gh, gpos = model.embed_inputs(tparams, tc, {
        "tokens": torch.from_numpy(tokens), "patch_embeds": pe})
    assert gh.dtype == torch.bfloat16 and wh.dtype == jnp.bfloat16
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    np.testing.assert_allclose(gh.float().numpy(),
                               np.asarray(wh, np.float32), atol=1e-2,
                               rtol=1e-2)
    exact = pe @ tparams.patch_proj.float()
    in_f32 = (gh[:, :tc.num_patches].float() - exact).abs().max()
    in_bf16 = ((pe.bfloat16() @ tparams.patch_proj).float()
               - exact).abs().max()
    assert in_f32 <= in_bf16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patched_prefill_then_decode_stays_finite(dtype):
    """The port's seeded init in either dtype: a patched prefill and 3
    greedy steps give finite logits and tokens in the vocabulary."""
    _, tc = _cfgs(dtype=dtype)
    params = model.init_params(tc, seed=2, device="cpu")
    tokens, patches = _batch(tc, seed=3)
    L = tc.num_patches + TOKENS
    logits, caches, plen = engine.prefill(params, tc, {
        "tokens": torch.from_numpy(tokens),
        "patch_embeds": torch.from_numpy(patches)}, L + 3)
    assert plen == L
    for i in range(3):
        tok = logits[:, -1].argmax(-1)[:, None]
        assert int(tok.min()) >= 0 and int(tok.max()) < tc.vocab_size
        logits, caches = decode.decode_step(params, tc, caches, tok, L + i)
        assert bool(torch.isfinite(logits).all())
