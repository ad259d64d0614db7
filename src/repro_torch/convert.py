"""Carry state across from the reference package (``repro``) as numpy.

The reference keeps packed colour masks as uint32; the port keeps the same
bit patterns in ``torch.int32`` tensors.  These helpers do the view at the
boundary, so a graph or a sketch pool built by one package can be handed to
the other and compared bit for bit.  `lm_params_from_jax` loads an LM
parameter tree in the reference's layout into the port's modules;
`lm_named_leaves` names a tree of that layout (parameters, gradients or
moments) by the port's parameter names, `lm_stacked_tree` builds that
layout from the port's names (the training checkpoint's), and
`adamw_state_from_jax` carries an optimizer state across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import rrr, tiles
from repro_torch.graph import csr
from repro_torch.models import common, model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def graph_from_numpy(indptr, src, dst, prob, num_vertices: int,
                     num_edges: int, device="cuda") -> csr.Graph:
    """A `csr.Graph` holding exactly the given CSR arrays (no re-sort: the
    edge order, hence every RNG counter, is kept)."""
    dev = device_lib.resolve(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return csr.Graph(indptr=put(indptr, np.int32), src=put(src, np.int32),
                     dst=put(dst, np.int32), prob=put(prob, np.float32),
                     num_vertices=int(num_vertices), num_edges=int(num_edges))


def masks_from_numpy(words: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 mask array → int32 bit-pattern tensor on ``device``."""
    arr = np.ascontiguousarray(words, np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device_lib.resolve(device))


def masks_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor → uint32 numpy array (a host copy)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def batches_from_numpy(visited: np.ndarray, roots: np.ndarray,
                       batch_indices, edge_visits=None,
                       device="cuda") -> list[rrr.RRRBatch]:
    """`rrr.RRRBatch` list from a reference pool's arrays: ``visited``
    (B, V, W) uint32, ``roots`` (B, C), ``batch_indices`` (B,) and
    optionally ``edge_visits`` (B, 2) (fused, unfused; -1 where not
    instrumented).  Assign the list to ``SketchStore.batches`` to serve the
    reference's pool."""
    masks = masks_from_numpy(visited, device)
    visits = (np.full((masks.shape[0], 2), -1, np.int64)
              if edge_visits is None else np.asarray(edge_visits))
    return [rrr.RRRBatch(masks[i], np.asarray(roots[i], np.int32), int(b),
                         int(visits[i, 0]), int(visits[i, 1]))
            for i, b in enumerate(batch_indices)]


def quantized_tiles_from_numpy(tile_src, tile_dst, q8, num_vertices: int,
                               num_edges: int, device="cuda"
                               ) -> tuple[tiles.TiledGraph, torch.Tensor]:
    """The port's quantised layout ``(tg, q8)`` (`tiles.quantized`) holding
    a reference layout's arrays as they are: ``tile_src``/``tile_dst`` of
    ``repro.core.tiles.from_graph`` (padding tiles kept) and its
    ``quantize_probs(prob)`` stack.  The reference's ``first_of_dst``
    flags become the port's run pointers."""
    dev = device_lib.resolve(device)
    q = torch.from_numpy(np.array(q8, np.uint8)).to(dev)
    t_dst = torch.from_numpy(np.array(tile_dst, np.int32)).to(dev)
    T = int(q.shape[1])
    n_blocks = -(-int(num_vertices) // T)
    tg = tiles.TiledGraph(
        prob=None, edge_id=None,
        tile_src=torch.from_numpy(np.array(tile_src, np.int32)).to(dev),
        tile_dst=t_dst, dst_run_ptr=tiles.run_pointers(t_dst, n_blocks),
        num_vertices=int(num_vertices), num_edges=int(num_edges),
        tile_size=T)
    return tg, q


# Leaves the reference keeps float32 in every dtype: MoE routers and the
# SSD mixer's per-head decay, skip and dt bias.
FLOAT32_LEAVES = frozenset({"router", "a_log", "d_skip", "dt_bias"})


def lm_params_from_jax(tree: dict, cfg: ModelConfig,
                       device="cuda") -> model.LM:
    """The port's `model.LM` holding the weights of a reference parameter
    tree (``repro.models.model.init_params``'s layout, leaves as numpy
    arrays or anything ``np.asarray`` takes): ``embedding``, ``unembed``,
    ``final_norm``, a VLM config's ``patch_proj``, a hybrid config's
    ``shared_attn`` and one stack per `model.stacks_of` entry, of
    ``block{i}`` leaves leading with the group axis; group ``g``'s block
    ``i`` goes to the next layer, in the reference's order.  Leaves are cast to the config's dtype on
    ``device`` one at a time, those of `FLOAT32_LEAVES` to float32 (the
    reference keeps them so in every dtype)."""
    dev = device_lib.resolve(device)
    dt = common.dtype_of(cfg.dtype)

    def put(a, dtype=dt):          # a host copy of our own, then the device
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    def tensors(leaves: dict, g=None) -> dict:
        """A (nested) dict of leaves, group ``g`` of each (all of it when
        ``g`` is None), as tensors."""
        return {k: tensors(a, g) if isinstance(a, dict)
                else put(a if g is None else a[g],
                         torch.float32 if k in FLOAT32_LEAVES else dt)
                for k, a in leaves.items()}

    def block(kind, p: dict, g=None):
        sel = (lambda a: a) if g is None else (lambda a: a[g])
        if kind in model.MAMBA_KINDS:
            return model.MambaBlock(kind, put(sel(p["norm1"])),
                                    common.param_dict(tensors(p["mamba"],
                                                              g)))
        return model.Block(
            kind, put(sel(p["norm1"])),
            common.param_dict(tensors(p["attn"], g)), put(sel(p["norm2"])),
            common.param_dict(tensors(p["moe" if kind == "moe" else "mlp"],
                                      g)))

    shared = (block("dense", tree["shared_attn"])
              if cfg.family == "hybrid" else None)
    layers = [block(kind, stack[f"block{i}"], g)
              for (pattern, groups), stack in zip(model.stacks_of(cfg),
                                                  tree["stacks"], strict=True)
              for g in range(groups) for i, kind in enumerate(pattern)]
    return model.LM(put(tree["embedding"]), put(tree["unembed"]),
                    put(tree["final_norm"]), layers, shared,
                    put(tree["patch_proj"]) if cfg.num_patches else None)


def lm_named_leaves(tree: dict, cfg: ModelConfig) -> dict:
    """The leaves of a tree in the reference's parameter layout under the
    port's names (``model.LM.named_parameters()``'s): a stacked leaf's
    group ``g`` goes to its layer, as in `lm_params_from_jax`.  Leaves are
    returned as they are (sliced, not copied)."""
    out = {"embedding": tree["embedding"], "unembed": tree["unembed"],
           "final_norm": tree["final_norm"]}

    def add(prefix: str, leaves: dict, g=None):
        for k, a in leaves.items():
            if isinstance(a, dict):
                add(f"{prefix}.{k}", a, g)
            else:
                out[f"{prefix}.{k}"] = a if g is None else a[g]

    i = 0
    for (pattern, groups), stack in zip(model.stacks_of(cfg), tree["stacks"],
                                        strict=True):
        for g in range(groups):
            for j in range(len(pattern)):
                add(f"layers.{i}", stack[f"block{j}"], g)
                i += 1
    if cfg.family == "hybrid":
        add("shared_attn", tree["shared_attn"])
    if cfg.num_patches:
        out["patch_proj"] = tree["patch_proj"]
    return out


def _nest(named: dict, prefix: str) -> dict:
    """The leaves named ``prefix.a.b…``, as a nested dict
    ``{a: {b: …}}``."""
    out: dict = {}
    for name, t in named.items():
        if not name.startswith(prefix + "."):
            continue
        *path, leaf = name[len(prefix) + 1:].split(".")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[leaf] = t
    return out


def _zip_map(fn, trees: list):
    """``fn`` over the leaves of equally shaped nested dicts, leaf-wise."""
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(trees)


def lm_stacked_tree(named: dict, cfg: ModelConfig, stack=torch.stack
                    ) -> dict:
    """The reverse of `lm_named_leaves`: leaves under the port's names
    (``model.LM.named_parameters()``'s, or gradients or moments keyed so)
    in the reference's parameter layout — ``stacks/<i>/block<j>/…`` with
    the group axis leading, and ``shared_attn`` and ``patch_proj`` where
    the config has them.  ``stack`` combines one leaf's per-group tensors
    (``torch.stack`` by default; a caller may stack on the host or build
    shape-only leaves)."""
    out = {k: named[k] for k in ("embedding", "unembed", "final_norm")}
    stacks, i = [], 0
    for pattern, groups in model.stacks_of(cfg):
        stacks.append({
            f"block{j}": _zip_map(stack, [
                _nest(named, f"layers.{i + g * len(pattern) + j}")
                for g in range(groups)])
            for j in range(len(pattern))})
        i += groups * len(pattern)
    out["stacks"] = stacks
    if cfg.family == "hybrid":
        out["shared_attn"] = _nest(named, "shared_attn")
    if cfg.num_patches:
        out["patch_proj"] = named["patch_proj"]
    return out


def adamw_state_from_jax(state, cfg: ModelConfig,
                         device="cuda") -> adamw.AdamWState:
    """The port's `optim.adamw.AdamWState` holding a reference AdamW state
    (``step``, and ``m`` / ``v`` in its parameter layout, as numpy or jax
    arrays): each moment under its parameter's port name, in its own dtype
    (float32 or bfloat16), on ``device``."""
    dev = device_lib.resolve(device)

    def put(a):
        dt = (torch.bfloat16 if str(getattr(a, "dtype", "")) == "bfloat16"
              else torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dt)

    return adamw.AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m={k: put(a) for k, a in lm_named_leaves(state.m, cfg).items()},
        v={k: put(a) for k, a in lm_named_leaves(state.v, cfg).items()})
