"""Mesh construction (PyTorch port of ``repro.launch.mesh``).

A function, not a module constant: importing this module touches no
process group.  The caller's process must already be in the default group
(`launch.accel.spawn` puts it there), unless every axis has size 1.
"""
from __future__ import annotations

from repro_torch.distributed.comm import Mesh


def make_mesh(shape: tuple, axes: tuple, *, device="cuda") -> Mesh:
    """The ``shape`` mesh with named ``axes`` over the default group, its
    collectives staged for ``device`` (the rank's compute device; the card
    unless the caller asks for ``"cpu"``)."""
    return Mesh(shape, axes, device=device)
