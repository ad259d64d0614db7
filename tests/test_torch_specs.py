"""`launch.specs` and `launch.mesh.production_shape` (the port's dry-run
stand-ins) against the reference's ``repro.launch.specs`` in process, for
every arch of the registry and every shape cell of ``SHAPES``: the batch,
the decode caches (the port's per-layer list mapped onto the reference's
stacked one, the layer order of `convert.lm_stacked_tree`), the
parameters and the AdamW moments, shapes and dtypes equal; and the batch,
cache and moment specs on abstract meshes of (2, 4), (16, 16) and
(2, 16, 16) equal the reference's ``PartitionSpec``s (the cache's leading
group dimension dropped)."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jregistry
from repro.distributed import sharding_rules as jrules
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models.config import SHAPES as JSHAPES
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.models import model
from repro_torch.models.config import SHAPES

torch.set_num_threads(1)

CELLS = [(a, s) for a in registry.ARCHS for s in SHAPES]
MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int32: jnp.int32}


class _Mesh:
    """The port's view of a mesh: axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _same(t: torch.Tensor, want) -> None:
    assert tuple(t.shape) == tuple(want.shape)
    assert jnp.dtype(_DT[t.dtype]) == jnp.dtype(want.dtype)


def _spec(p, rank: int) -> tuple:
    """A PartitionSpec as the port's tuple, padded to ``rank``."""
    return tuple(p) + (None,) * (rank - len(tuple(p)))


def _layer_slots(cfg):
    """For each port layer: (stack, block, groups), the reference's."""
    out = []
    for s, (pattern, groups) in enumerate(model.stacks_of(cfg)):
        for _ in range(groups):
            out.extend((s, f"block{j}", groups) for j in range(len(pattern)))
    return out


def _cache_pairs(cfg, got, want):
    """(port dict, reference dict, groups) of every cache part."""
    for c, (s, block, groups) in zip(got, _layer_slots(cfg), strict=True):
        ref = want[s][block]
        parts = c if isinstance(c, tuple) else (c,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for p, r in zip(parts, refs, strict=True):
            assert set(p) == set(r)
            yield p, r, groups


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_equal_the_reference(arch, shape):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    sh, jsh = SHAPES[shape], JSHAPES[shape]
    for labels in (True, False):
        got = specs.batch_specs(cfg, sh, with_labels=labels)
        want = jspecs.batch_specs(jcfg, jsh, with_labels=labels)
        assert set(got) == set(want)
        for k in got:
            _same(got[k], want[k])
    if sh.kind == "decode":
        caches, tok, cur = specs.decode_specs(cfg, sh)
        jc, jtok, _ = jspecs.decode_specs(jcfg, jsh)
        _same(tok, jtok)
        assert cur == sh.seq_len - 1
        for p, r, groups in _cache_pairs(cfg, caches, jc):
            for k in p:
                assert tuple(r[k].shape) == (groups, *p[k].shape)
                assert jnp.dtype(_DT[p[k].dtype]) == r[k].dtype
    if sh.kind == "train":
        params = specs.param_specs(cfg)
        named = dict(params.named_parameters())
        stacked = convert.lm_stacked_tree(
            named, cfg, stack=lambda xs: torch.empty(
                (len(xs), *xs[0].shape), dtype=xs[0].dtype, device="meta"))
        want = jspecs.param_specs(jcfg)
        got_flat = jax.tree_util.tree_flatten_with_path(
            stacked, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
        want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
        for (_, g), (_, w) in zip(got_flat, want_flat):
            _same(g, w)
        opt = specs.opt_specs(cfg, params)
        jopt = jspecs.opt_specs(jcfg, want)
        dt = jopt.m["embedding"].dtype
        for tree in (opt.m, opt.v):
            assert set(tree) == set(named)
            for k, t in tree.items():
                assert tuple(t.shape) == tuple(named[k].shape)
                assert jnp.dtype(_DT[t.dtype]) == dt
        assert opt.step.shape == () and jopt.step.shape == ()


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_shardings_equal_the_reference(arch, mesh_shape, axes):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    jm = jax.sharding.AbstractMesh(mesh_shape, axes)
    tm = _Mesh(mesh_shape, axes)
    for name in SHAPES:
        got = specs.batch_shardings(tm, specs.batch_specs(cfg, SHAPES[name]))
        want = jspecs.batch_shardings(jm, jspecs.batch_specs(jcfg,
                                                             JSHAPES[name]))
        for k, v in got.items():
            assert v == _spec(want[k].spec, len(v)), (name, k)
    for name in ("decode_32k", "long_500k"):
        caches = specs.decode_specs(cfg, SHAPES[name])[0]
        jc = jspecs.decode_specs(jcfg, JSHAPES[name])[0]
        got = specs.cache_shardings(tm, caches)
        want = jspecs.cache_shardings(jm, jc)
        for p, r, _ in _cache_pairs(cfg, got, want):
            for k, v in p.items():
                assert v == _spec(r[k].spec, len(v) + 1)[1:], (name, k)
    params = specs.param_specs(cfg)
    p_sh = specs.param_shardings(tm, cfg, params)
    o_sh = specs.opt_shardings(tm, specs.opt_specs(cfg, params), p_sh)
    assert o_sh.m == p_sh and o_sh.v == p_sh and o_sh.step == ()
    # The reference's moments take its parameters' shardings; the port's
    # parameter specs are the reference's (test_torch_sharding_rules).
    j_psh = jrules.param_shardings(jm, jspecs.param_specs(jcfg))
    j_osh = jspecs.opt_shardings(jm, None, j_psh)
    assert j_osh.m is j_psh and j_osh.v is j_psh


def test_production_shape_is_the_reference(monkeypatch):
    seen = []
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: seen.append((tuple(shape),
                                                         tuple(axes))))
    for multi in (False, True):
        jmesh.make_production_mesh(multi_pod=multi)
        assert tmesh.production_shape(multi) == seen[-1]
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
