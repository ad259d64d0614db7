"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (the reference's ``optim/compress.py``).

Each leaf is quantised per tensor to int8 against a scale shared over the
axis (its ``pmax``), the int8 values are summed as int32 over the axis,
and the mean is dequantised; the quantisation residual stays on its rank
and is added to the next step's gradient (error feedback), so the
optimizer still converges.  The wire carries int8 values as int32 here
(`distributed.comm.Mesh.psum`), and one scalar per leaf for the scale.
"""
from __future__ import annotations

import torch

_LEVELS = 127.0


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q int8, scale float32 scalar);
    the reference's arithmetic, bit for bit."""
    xf = x.float()
    scale = (xf.abs().max() / _LEVELS).clamp_min(1e-12)
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: dict, mesh, axis: str) -> tuple[dict, dict]:
    """Leaf-wise int8 all-reduce over ``mesh``'s ``axis`` with shared
    (``pmax``) scales, on every rank of it.  Returns (the mean gradient,
    this rank's residual), each a dict like ``grads`` in its dtypes; the
    caller carries the residual into the next step."""
    n = mesh.axis_size(axis)
    mean, res = {}, {}
    for k, g in grads.items():
        _, scale = quantize(g)
        scale = mesh.pmax(scale, axis)
        # re-quantize against the shared scale so the sum is coherent
        q = torch.round(g.float() / scale).clamp(-127, 127).to(torch.int8)
        total = mesh.psum(q.to(torch.int32), axis)
        mean[k] = (total.float() * scale / n).to(g.dtype)
        res[k] = (g.float() - dequantize(q, scale)).to(g.dtype)
    return mean, res
