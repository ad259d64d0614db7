"""Manifest-described, atomic checkpointing (PyTorch port of
``repro.checkpoint.manager``, single-device form).

Layout per step:  ``<dir>/step_<N>/{manifest.json, leaf_<i>.npy …}``
written into ``step_<N>.tmp`` then ``os.replace``d — a crashed writer can
never produce a half checkpoint that restore would accept.

A tree is nested dicts (keys visited in sorted order, as jax flattens a
dict), lists, tuples and dataclasses (fields in order, as jax flattens a
registered dataclass: the training state ``(params, AdamWState)``), with
numpy arrays or tensors as leaves; each leaf's path is its keys, indices
and ``.field`` names joined by ``/``.  Leaf order, file names and path
strings are the reference's, so either package reads the other's
checkpoints.  A bf16 tensor is saved as its 16-bit patterns under the
dtype name ``bfloat16`` (numpy has no bf16 of its own).  A leaf is saved as one global host array, whatever
mesh wrote it: a sharded pool's ranks each place their own block of it
(`serve.distributed.ShardedSketchStore.restore`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, prefix: tuple = ()):
    """(paths, leaves) of ``tree`` in jax's flattening order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return ["/".join(str(p) for p in prefix)], [tree]
    paths, leaves = [], []
    for key, sub in items:
        p, lv = _flatten(sub, prefix + (key,))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in `_flatten` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    return leaves.pop(0)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` and the dtype name its manifest entry
    records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(directory: str, step: int, tree: Any, *, keep: int = 3,
         blocking: bool = True,
         extra: Optional[dict] = None) -> threading.Thread | None:
    """Write checkpoint for ``step``.  ``blocking=False`` returns the writer
    thread; the leaves are copied to the host before this returns either
    way.  ``extra``: JSON-serialisable metadata embedded in the manifest,
    readable without loading any leaf (`read_manifest`)."""
    paths, leaves = _flatten(tree)
    host_leaves = [_host(x) for x in leaves]

    def _write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (p, (a, dtype)) in enumerate(zip(paths, host_leaves)):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), a)
            manifest["leaves"].append(
                {"path": p, "file": fname, "shape": list(a.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                          # atomic publish
        _cleanup(directory, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _cleanup(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def read_manifest(directory: str, step: Optional[int] = None) -> dict:
    """Manifest dict (step, extra, per-leaf path/shape/dtype) without
    touching any leaf file."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def restore(directory: str, target_tree: Any, step: Optional[int] = None,
            as_numpy: bool = False) -> tuple[Any, int]:
    """Restore into the structure of ``target_tree`` (values ignored, shapes
    checked).  Leaves come back as CPU tensors, or as numpy arrays with
    ``as_numpy=True`` — for callers that place them themselves, as the
    sketch store does with its uint32 masks (a bf16 leaf comes back as a
    tensor either way)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    paths, leaves = _flatten(target_tree)
    out = []
    for p, ref in zip(paths, leaves):
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = np.load(os.path.join(d, entry["file"]))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{p}: shape {arr.shape} != {tuple(ref.shape)}")
        if entry["dtype"] == "bfloat16":            # 16-bit patterns
            out.append(torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16))
            continue
        want = np.dtype(entry["dtype"])
        if arr.dtype != want:                       # np.save stored raw bits
            arr = arr.view(want)
        out.append(arr if as_numpy else torch.from_numpy(arr))
    return _unflatten(target_tree, out), step
