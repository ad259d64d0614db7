"""Mesh construction (PyTorch port of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no
process group.  The caller's process must already be in the default group
(`launch.accel.spawn` puts it there), unless every axis has size 1.
"""
from __future__ import annotations

from repro_torch.distributed.comm import Mesh


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axes) of the production mesh, the reference's: 16×16 = 256
    ranks over ``("data", "model")``, and 2×16×16 over ``("pod", "data",
    "model")`` across two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """The production mesh (`production_shape`) over the default group;
    raises, as `Mesh` does, unless the group holds 256 (512 with
    ``multi_pod``) ranks."""
    return Mesh(*production_shape(multi_pod), device=device)


def make_mesh(shape: tuple, axes: tuple, *, device="cuda",
              timeout_s=None, members=None) -> Mesh:
    """The ``shape`` mesh with named ``axes`` over the default group (or
    over its ranks ``members``, ascending: `comm.Mesh`), its
    collectives staged for ``device`` (the rank's compute device; the card
    unless the caller asks for ``"cpu"``) and bounded by ``timeout_s``
    (default: the default group's timeout)."""
    return Mesh(shape, axes, device=device, timeout_s=timeout_s,
                members=members)
