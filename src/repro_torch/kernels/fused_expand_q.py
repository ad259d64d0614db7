"""The quantised IC expansion: ``quantize_probs`` and the CUDA wrapper of
``csrc/fused_expand_q.cu``.

Replaces both Pallas kernels of ``repro/kernels/fused_expand_q.py``:
``fused_expand_q`` (the dense grid) and ``fused_expand_q_gathered`` (a
compacted, null-padded tile list).  The tile stack is one uint8 threshold
``q`` per slot (1 B where the float32 layout needs 8 B of probability and
edge id), the RNG counter is the slot's position ``tile·T² + row·T + col``
(mod 2³²), and one hash feeds four colour lanes:

    colour c crosses the edge in slot s  ⇔  byte (c % 4) of
        hash_u32(seed, level, cell(s), c // 4)  ≤  q[s]  ∧  q[s] > 0,

so p̂ = (q + 1)/256, exact at p = 0 and p = 1.  The kernel shares
``fused_expand``'s walk (``csrc/slot_expand.cuh``) over the quantised slot
list (`core.tiles.q_slot_list`: the slots with ``q > 0``, each with its
rows, ``q`` and the cell of its original tile id), every entry or those of
a list of original tile ids read in place, so the list mode needs no null
tile and no gathered copy; one hash serves the four colours of a pending
nibble.  Its plain version is `kernels.ref.fused_expand_q_slots_ref`,
which the tile-form `kernels.ref.fused_expand_q_ref` defines;
`kernels.ops.fused_expand_q` picks between the kernel and the plain
version by device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_expand import draw_args, launch_slot_kernel


def quantize_probs(prob: torch.Tensor) -> torch.Tensor:
    """float32 probabilities in [0, 1] → uint8 thresholds
    ``clip(round(p·256) − 1, 0, 255)``, 0 where ``p ≤ 0`` (the reference's
    ``fused_expand_q.py::quantize_probs``).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the k/256 boundaries agree."""
    prob = prob.to(torch.float32)
    q = torch.clamp(torch.round(prob * 256.0) - 1.0, 0, 255)
    return torch.where(prob > 0, q, 0).to(torch.uint8)


def fused_expand_q_cuda(slots, frontier: torch.Tensor,
                        visited: torch.Tensor, seed: int, level: int,
                        tile_ids: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Launch the kernel on ``frontier``'s stream; returns the (Vo, W) int32
    next frontier.  Arguments as `fused_expand_cuda`, with ``slots`` the
    quantised stack's `core.tiles.q_slot_list` (uint8 values, cell keys);
    a listed tile draws with its own id."""
    return launch_slot_kernel("fused_expand_q", torch.uint8, slots,
                              frontier, visited, tile_ids,
                              draw_args(seed, level))
