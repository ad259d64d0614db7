"""CUDA wrapper of ``csrc/fused_expand.cu`` — one fused-BPT IC level over
the slot list of the dst-sorted adjacency tiles.

Replaces the Pallas kernel ``repro/kernels/fused_expand.py::fused_expand``.
The kernel walks the layout's slot list (`core.tiles.ic_slot_list`: per
tile, the slots with ``prob > 0``, each with its source and destination
rows, probability and edge id), one thread per entry over many CTAs, and
merges the entries into the output with a warp reduction and ``atomicOr``
after zeroing it on the stream; threads hash only pending colours.  The
list is every entry (``tile_ids`` None) or the entries of a compacted list
of ascending tile ids, read in place (the sparse frontier).  Its roofline
bound is set by bytes (see the source's header).  Its plain version is
`kernels.ref.fused_expand_slots_ref`, which the tile-form
`kernels.ref.fused_expand_ref` defines; `kernels.ops.fused_expand` picks
between the kernel and the plain version by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# The C interface the slot-list kernels share, up to their gate's own
# arguments (then the stream).
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int])


def check_slot_list(kernel: str, slots, frontier, visited, tile_ids, dev,
                    value_dtype) -> int:
    """The checks the three slot-list kernels' wrappers share (``slots`` a
    `core.tiles.SlotList` whose values are ``value_dtype``); returns the
    word count W."""
    for name in ("slot_ptr", "src_row", "dst_row", "key"):
        _build.check_arg(kernel, name, getattr(slots, name), torch.int32, 1,
                         dev)
    _build.check_arg(kernel, "slot values", slots.value, value_dtype, 1, dev)
    _build.check_arg(kernel, "frontier", frontier, torch.int32, 2, dev)
    _build.check_arg(kernel, "visited", visited, torch.int32, 2, dev)
    if tile_ids is not None:
        _build.check_arg(kernel, "tile_ids", tile_ids, torch.int32, 1, dev)
    n = slots.num_entries
    if any(t.shape[0] != n for t in (slots.dst_row, slots.value, slots.key)):
        raise ValueError(f"{kernel}: the slot list's arrays disagree")
    if frontier.shape[1] != visited.shape[1] \
            or frontier.shape[0] < slots.src_rows \
            or visited.shape[0] < slots.dst_rows:
        raise ValueError(f"{kernel}: frontier and visited must have one "
                         f"word count, with the {slots.src_rows} source and "
                         f"{slots.dst_rows} destination rows the slot list "
                         f"indexes; got {tuple(frontier.shape)} and "
                         f"{tuple(visited.shape)}")
    w = frontier.shape[1]
    if not 1 <= w <= 8:
        raise ValueError(f"{kernel}: words {w} must be in [1, 8]")
    return w


def launch_slot_kernel(kernel: str, value_dtype, slots,
                       frontier: torch.Tensor, visited: torch.Tensor,
                       tile_ids, gate_args=()) -> torch.Tensor:
    """Check, then launch ``csrc/<kernel>.cu`` on ``frontier``'s stream;
    returns the output mask.  The slot-list kernels share one C interface
    up to ``gate_args``, their gate's own arguments as ctypes values (the
    seed and level of a draw, the uniform table of LT); a wrapper checks
    those before it calls this."""
    dev = frontier.device
    w = check_slot_list(kernel, slots, frontier, visited, tile_ids, dev,
                        value_dtype)
    fn = _build.launcher(kernel, f"{kernel}_launch",
                         _ARGTYPES + [type(a) for a in gate_args]
                         + [ctypes.c_void_p])
    out = torch.empty_like(visited)
    err = fn(slots.slot_ptr.data_ptr(), slots.src_row.data_ptr(),
             slots.dst_row.data_ptr(), slots.value.data_ptr(),
             slots.key.data_ptr(), slots.num_entries,
             _build.data_ptr(tile_ids),
             -1 if tile_ids is None else tile_ids.shape[0],
             frontier.data_ptr(), visited.data_ptr(), out.data_ptr(),
             visited.shape[0], w, *gate_args,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    return out


def draw_args(seed: int, level: int) -> tuple:
    """The IC gates' arguments: the traversal seed and the level, uint32."""
    return (ctypes.c_uint32(int(seed) & 0xFFFFFFFF),
            ctypes.c_uint32(int(level) & 0xFFFFFFFF))


def fused_expand_cuda(slots, frontier: torch.Tensor,
                      visited: torch.Tensor, seed: int, level: int,
                      tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on ``frontier``'s stream; returns the (Vo, W) int32
    next frontier.  ``slots`` is the layout's `core.tiles.ic_slot_list`
    (or a row shard's list); ``visited`` must already include the
    frontier's bits at its rows; ``frontier`` and ``visited`` hold at
    least the list's source and destination rows (one shape on one
    device; a shard reads the global frontier and writes its local
    rows).  ``tile_ids``: ascending int32 ids
    of the listed tiles (None: every tile), each below the layout's tile
    count."""
    return launch_slot_kernel("fused_expand", torch.float32, slots, frontier,
                              visited, tile_ids, draw_args(seed, level))
