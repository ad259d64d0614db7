"""Device resolution shared by every entry point that creates tensors."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA request without a GPU raises
    (there is no silent CPU fallback — pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (host clocks around GPU work need
    it; a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
