"""Sharding rules for training the LM substrate (the reference's
``distributed/sharding_rules.py``): where each parameter leaf lives on a
mesh of axes ``("data", "model")`` or ``("pod", "data", "model")``.

Each leaf path maps to candidate specs over ``fsdp = (pod, data)`` and
``model`` (`_rules`, the reference's table, pattern for pattern and in
its order: the first pattern that matches decides, so ``experts_w1`` takes
the ``w1$`` rule as it does there).  `concretize` keeps the candidate
that shards the most ways after `sanitize` drops every axis that the
mesh lacks or that does not divide its dimension.

A spec is a plain tuple, one entry a dimension: None (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product, the first axis major), as the reference's ``PartitionSpec``
entries are.  A mesh is anything with ``axis_names`` and a ``shape`` dict
(`distributed.comm.Mesh`).

`cache_spec` is the reference's ``launch/specs._CACHE_RULES`` for one
decode-cache leaf of the port's per-layer caches (`models.decode`):
each attention cache's sequence over ``model`` and its batch over the
data axes, the SSM state's heads and the conv tail's channels over
``model``, the reference's stacked group dimension dropped.

`param_shardings` gives every leaf of the port's model (by name, with
its full shape) its spec: the reference's `concretize` for the leaf's
path and shape in the reference's stacked layout (`reference_path`, from
the model's ``stacks``, `models.model.stacks_of`), with the stacked group
dimension dropped, since the port's leaves are per layer.  The models
build their layouts from it (`models.model.layout_on`); nothing here
imports them.  The
reference's process-global mesh (``set_mesh`` / ``get_mesh``) and its
layout hints (``shard``, ``shard_first``, ``constrain_params``) have no
counterpart: the port passes its mesh explicitly and gathers one layer at
a time (`distributed.fsdp`).
"""
from __future__ import annotations

import math
import re

_F = "__fsdp__"          # placeholder replaced by the mesh's fsdp axes


def fsdp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_axes(mesh=None) -> tuple:
    """The batch's axes: ``("pod", "data")`` shrunk to those the mesh has
    (``("data",)`` without a mesh, as the reference's default)."""
    return ("data",) if mesh is None else fsdp_axes(mesh)


def entry_axes(entry) -> tuple:
    """The axes of one spec entry, in order (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, axis) -> int:
    return math.prod(mesh.shape[a] for a in entry_axes(axis))


def sanitize(mesh, spec: tuple, shape) -> tuple:
    """Drop spec axes that are absent from the mesh or don't divide; trim
    a spec longer than the value's rank."""
    out = []
    for dim, axis in enumerate(tuple(spec)[: len(shape)]):
        axes = tuple(a for a in entry_axes(axis) if a in mesh.axis_names)
        if axes and shape[dim] % _axis_size(mesh, axes) == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def _rules():
    """pattern → candidate specs, best-first (the reference's table)."""
    return [
        (r"embedding$", [(None, _F)]),          # (V, D): vocab rep, D fsdp
        (r"unembed$", [(_F, "model")]),         # (D, V)
        (r"patch_proj$", [(_F, None)]),
        (r"wq$", [(_F, "model", None), (_F, None, "model")]),
        (r"wk$", [(_F, "model", None), (_F, None, "model")]),
        (r"wv$", [(_F, "model", None), (_F, None, "model")]),
        (r"bq$", [("model", None), (None, "model")]),
        (r"bk$", [("model", None), (None, "model")]),
        (r"bv$", [("model", None), (None, "model")]),
        (r"wo$", [("model", None, _F), (None, "model", _F)]),
        (r"w_dq$", [(_F, None)]),               # MLA down projections
        (r"w_dkv$", [(_F, None)]),
        (r"w_uq$", [(None, "model", None), (None, None, "model")]),
        (r"w_uk$", [(None, "model", None), (None, None, "model")]),
        (r"w_uv$", [(None, "model", None), (None, None, "model")]),
        (r"w1$", [(_F, "model")]),              # (D, F)
        (r"w3$", [(_F, "model")]),
        (r"w2$", [("model", _F)]),              # (F, D)
        (r"router$", [(_F, None)]),             # (D, E)
        (r"experts_w1$", [("model", _F, None)]),  # (E, D, Fe)
        (r"experts_w3$", [("model", _F, None)]),
        (r"experts_w2$", [("model", None, _F)]),  # (E, Fe, D)
        (r"in_proj$", [(_F, "model")]),         # mamba (D, inner-cat)
        (r"out_proj$", [("model", _F)]),        # (di, D)
        (r"conv$", [(None, "model")]),          # (w, channels)
        (r"(a_log|d_skip|dt_bias)$", [("model",)]),
        (r"(scale|norm.*)$", [(None,)]),        # norms replicated
    ]


# Decode caches, the reference's ``_CACHE_RULES`` in its order (leaf key
# → spec over the port's per-layer shape; "__dp__" the data axes).
_DP = "__dp__"
CACHE_RULES = [
    ("k_rope", (_DP, "model", None)),
    ("conv", (_DP, None, "model")),
    ("state", (_DP, "model", None, None)),
    ("k", (_DP, "model", None, None)),
    ("v", (_DP, "model", None, None)),
    ("c", (_DP, "model", None)),
]


def _dp_entry(mesh):
    """The data axes as one spec entry (a tuple of several, one axis
    alone, or None)."""
    dp = fsdp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_spec(mesh, shape) -> tuple:
    """A batch leaf's spec (the reference's ``batch_shardings``): rows
    over the data axes, the rest replicated, sanitized."""
    return sanitize(mesh, (_dp_entry(mesh),) + (None,) * (len(shape) - 1),
                    shape)


def cache_spec(mesh, key: str, shape) -> tuple:
    """The spec of a decode-cache leaf named ``key`` (its dict key) of
    per-layer ``shape``: the first `CACHE_RULES` entry of that name,
    sanitized; replicated if none names it."""
    for name, spec in CACHE_RULES:
        if key == name:
            dp = _dp_entry(mesh)
            return sanitize(mesh, tuple(dp if a == _DP else a for a in spec),
                            shape)
    return (None,) * len(shape)


def spec_candidates(path: str, shape) -> list[tuple]:
    """Candidate specs for one leaf (mesh-independent), leading dims
    padded with None."""
    for pat, cands in _rules():
        if re.search(pat, path):
            return [(None,) * (len(shape) - len(spec)) + tuple(spec)
                    for spec in cands]
    return [(None,) * len(shape)]


def spec_for(path: str, shape) -> tuple:
    return spec_candidates(path, shape)[0]


def _concretize_one(mesh, spec: tuple, shape) -> tuple:
    fs = _dp_entry(mesh)
    return sanitize(mesh, tuple(fs if a == _F else a for a in spec), shape)


def _shard_ways(mesh, spec: tuple) -> int:
    return math.prod(_axis_size(mesh, a) for a in spec if a is not None)


def concretize(mesh, path: str, shape) -> tuple:
    """The candidate that keeps the most sharding after `sanitize`
    (best-first on ties)."""
    best, best_ways = None, 0
    for cand in spec_candidates(path, shape):
        spec = _concretize_one(mesh, cand, shape)
        ways = _shard_ways(mesh, spec)
        if ways > best_ways:
            best, best_ways = spec, ways
    return best if best is not None else (None,) * len(shape)


def reference_path(name: str, stacks) -> tuple[str, int | None]:
    """(the reference's path of the port's leaf ``name``, the number of
    groups of the stack that holds it there, None for a leaf that is not
    stacked): ``layers.<i>.…`` becomes ``stacks/<s>/block<j>/…`` for the
    stack and pattern position of layer i in ``stacks``, the model's
    ``(pattern, groups)`` list (`models.model.stacks_of`); ``shared_attn``
    and the top-level leaves keep their names."""
    parts = name.split(".")
    if parts[0] != "layers":
        return "/".join(parts), None
    i = int(parts[1])
    for s, (pattern, groups) in enumerate(stacks):
        if i < groups * len(pattern):
            return "/".join([f"stacks/{s}/block{i % len(pattern)}",
                             *parts[2:]]), groups
        i -= groups * len(pattern)
    raise ValueError(f"{name}: no layer {parts[1]} in stacks {stacks}")


def param_shardings(mesh, shapes: dict, stacks) -> dict:
    """Port name → spec for every leaf of ``shapes`` (name → full shape)
    of a model whose layers form ``stacks`` (`reference_path`): the
    reference's `concretize` in its stacked layout, the group dimension
    dropped (module docstring)."""
    out = {}
    for name, shape in shapes.items():
        path, groups = reference_path(name, stacks)
        shape = tuple(shape)
        out[name] = (concretize(mesh, path, shape) if groups is None
                     else concretize(mesh, path, (groups, *shape))[1:])
    return out
