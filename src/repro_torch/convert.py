"""Carry state across from the reference package (``repro``) as numpy.

The reference keeps packed colour masks as uint32; the port keeps the same
bit patterns in ``torch.int32`` tensors.  These helpers do the view at the
boundary, so a graph or a sketch pool built by one package can be handed to
the other and compared bit for bit.  `lm_params_from_jax` loads an LM
parameter tree in the reference's layout into the port's modules.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import rrr, tiles
from repro_torch.graph import csr
from repro_torch.models import common, model
from repro_torch.models.config import ModelConfig


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


def lm_params_from_jax(tree: dict, cfg: ModelConfig,
                       device="cuda") -> model.LM:
    """The port's `model.LM` holding the weights of a reference parameter
    tree (``repro.models.model.init_params``'s layout, leaves as numpy
    arrays or anything ``np.asarray`` takes): ``embedding``, ``unembed``,
    ``final_norm`` and one stack per `model.stacks_of` entry, of
    ``block{i}`` leaves leading with the group axis; group ``g``'s block
    ``i`` goes to the next layer, in the reference's order.  Leaves are
    cast to the config's dtype on ``device`` one at a time, MoE routers to
    float32 (the reference keeps them so in every dtype)."""
    model.check_supported(cfg)
    dev = device_lib.resolve(device)
    dt = common.dtype_of(cfg.dtype)

    def put(a, dtype=dt):          # a host copy of our own, then the device
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    def tensors(leaves: dict, g: int) -> dict:
        return {k: tensors(a, g) if isinstance(a, dict)
                else put(a[g], torch.float32 if k == "router" else dt)
                for k, a in leaves.items()}

    layers = []
    for (pattern, groups), stack in zip(model.stacks_of(cfg),
                                        tree["stacks"], strict=True):
        for g in range(groups):
            for i, kind in enumerate(pattern):
                block = stack[f"block{i}"]
                ffn = block["moe" if kind == "moe" else "mlp"]
                layers.append(model.Block(
                    kind, put(block["norm1"][g]),
                    common.param_dict(tensors(block["attn"], g)),
                    put(block["norm2"][g]),
                    common.param_dict(tensors(ffn, g))))
    return model.LM(put(tree["embedding"]), put(tree["unembed"]),
                    put(tree["final_norm"]), layers)
