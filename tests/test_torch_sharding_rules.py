"""Port ≡ reference for the sharding rules (`distributed.sharding_rules`).

For every arch of the registry, full and smoke, on meshes (8,), (2, 4),
(1, 8), (16, 16) and (2, 16, 16): the port's spec of every leaf of
`model.param_shapes` equals the reference's ``concretize`` of the leaf's
path and shape in ``specs.param_specs`` (its stacked layout), with the
group dimension dropped.  The reference is called in process with a
stand-in mesh that has the two attributes it reads, ``axis_names`` and
``shape``.  Then ``tests/launch_check.py``'s sanity check on the
qwen1.5-110b smoke at 2×4, the card's full-width cuts against their
smoke configs at 2×2, and the rank's slices of `fsdp.Layout`."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.distributed import sharding_rules as jrules
from repro.launch import specs as jspecs
from repro_torch.configs import registry
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding_rules as rules
from repro_torch.models import model

torch.set_num_threads(1)

MESHES = [(8,), (2, 4), (1, 8), (16, 16), (2, 16, 16)]


@dataclasses.dataclass
class StandIn:
    axis_names: tuple
    shape: dict
    coords: dict = None

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]


def stand_in(shape, coords=None) -> StandIn:
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]
    return StandIn(axes, dict(zip(axes, shape)), coords)


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _named_specs(specs, cfg) -> dict:
    """The reference's spec tree (stacked) under the port's names, the
    group dimension dropped from stacked leaves."""
    out = {k: specs[k] for k in ("embedding", "unembed", "final_norm")}

    def add(prefix, leaves, stacked):
        for k, v in leaves.items():
            if isinstance(v, dict):
                add(f"{prefix}.{k}", v, stacked)
            else:
                out[f"{prefix}.{k}"] = v[1:] if stacked else v

    i = 0
    for (pattern, groups), stack in zip(model.stacks_of(cfg),
                                        specs["stacks"]):
        for _ in range(groups):
            for j in range(len(pattern)):
                add(f"layers.{i}", stack[f"block{j}"], True)
                i += 1
    if "shared_attn" in specs:
        add("shared_attn", specs["shared_attn"], False)
    if "patch_proj" in specs:
        out["patch_proj"] = specs["patch_proj"]
    return out


def _norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis (the reference writes a
    composite fsdp entry as a tuple, a single axis as its name)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_every_leaf_takes_the_references_spec(arch, smoke):
    get, jget = ((registry.smoke, jregistry.smoke) if smoke
                 else (registry.get, jregistry.get))
    cfg, jcfg = get(arch), jget(arch)
    shapes = {k: tuple(t.shape) for k, t in
              model.param_shapes(cfg).named_parameters()}
    for mshape in MESHES:
        mesh = stand_in(mshape)
        want = _named_specs(_spec_tree(jcfg, mesh), jcfg)
        got = rules.param_shardings(mesh, shapes, model.stacks_of(cfg))
        assert set(got) == set(want) == set(shapes)
        for name in shapes:
            assert _norm(got[name]) == _norm(want[name]), (mshape, name)
            assert len(got[name]) == len(shapes[name])


def _spec_tree(jcfg, mesh):
    """The reference's concretized spec of every leaf of its parameter
    skeleton (``specs.param_specs``), as a tree of tuples."""
    shapes = jspecs.param_specs(jcfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(treedef, [
        tuple(jrules.concretize(mesh, _path(p), leaf.shape))
        for p, leaf in flat])


def test_sharded_dims_divide_on_the_qwen_smoke_at_2x4():
    """``tests/launch_check.py``'s sanity check, on the port: every
    sharded dim divides, and as many dims are sharded as the
    reference's."""
    cfg, jcfg = registry.smoke("qwen1.5-110b"), jregistry.smoke(
        "qwen1.5-110b")
    mesh = stand_in((2, 4))
    shapes = {k: tuple(t.shape) for k, t in
              model.param_shapes(cfg).named_parameters()}
    n_sharded = 0
    specs = rules.param_shardings(mesh, shapes, model.stacks_of(cfg))
    for name, spec in specs.items():
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            assert shapes[name][dim] % rules._axis_size(mesh, ax) == 0
            n_sharded += 1
    # The reference counts a stacked leaf once; the port once per layer.
    per_layer = sum(
        sum(a is not None for a in spec)
        for name, spec in _named_specs(_spec_tree(jcfg, mesh), jcfg).items())
    assert n_sharded == per_layer > 0


def test_the_experts_take_the_w1_rule_as_in_the_reference():
    """``experts_w1`` matches the table's ``w1$`` pattern before its own,
    in both packages: (None, fsdp, model), not expert parallel."""
    mesh = stand_in((2, 2))
    for path, shape, want in [
            ("stacks/1/block0/moe/experts_w1", (3, 4, 64, 64),
             (None, None, "data", "model")),
            ("stacks/1/block0/moe/experts_w2", (3, 4, 64, 64),
             (None, None, "model", "data"))]:
        assert rules.concretize(mesh, path, shape) == want
        assert tuple(jrules.concretize(mesh, path, shape)) == want


@pytest.mark.parametrize("arch,cuts", [
    ("llama3.2-3b", {"num_layers": 2}),
    ("llama4-maverick-400b-a17b", {"num_layers": 2, "num_experts": 4})],
    ids=["llama3.2-3b", "llama4-maverick-400b-a17b"])
def test_the_cards_full_width_cuts_take_their_smoke_specs(arch, cuts):
    """On a 2×2 mesh every leaf of the full-width cuts that
    ``chip_smoke.py`` trains sharded takes the spec its smoke config's
    leaf takes, so the smoke configs' gradient checks on 2×2
    (``tests/test_torch_train_mesh.py``) cut the same dimensions."""
    mesh = stand_in((2, 2))

    def specs(cfg):
        shapes = {k: tuple(t.shape) for k, t in
                  model.param_shapes(cfg).named_parameters()}
        return rules.param_shardings(mesh, shapes, model.stacks_of(cfg))

    full = specs(dataclasses.replace(registry.get(arch), **cuts))
    smoke = specs(registry.smoke(arch))
    assert full and set(full) <= set(smoke)
    for name, spec in full.items():
        assert spec == smoke[name], name


@pytest.mark.parametrize("mshape", [(2, 2), (2, 2, 2)])
def test_the_ranks_slices_tile_every_leaf(mshape):
    """Every rank's `fsdp.Layout` slices of every leaf of the deepseek
    smoke cover the leaf exactly once: their sizes add up to the leaf's
    for the sharded axes, and a leaf replicated on an axis is held whole
    by each of its positions."""
    cfg = registry.smoke("deepseek-v3-671b")
    axes = stand_in(mshape).axis_names
    shapes = {k: tuple(t.shape) for k, t in
              model.param_shapes(cfg).named_parameters()}
    layouts = []
    for coords in np.ndindex(*mshape):
        mesh = stand_in(mshape, dict(zip(axes, coords)))
        layouts.append(fsdp.Layout(
            mesh, rules.param_shardings(mesh, shapes, model.stacks_of(cfg)),
            shapes))
    for name, shape in shapes.items():
        cover = np.zeros(shape, np.int32)
        for lay in layouts:
            cover[lay.slices(name)] += 1
        reps = int(np.prod([layouts[0].mesh.shape[a]
                            for a in layouts[0].replicated_axes(name)]))
        assert (cover == reps).all(), name
