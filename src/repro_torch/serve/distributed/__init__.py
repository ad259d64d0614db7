"""Serving front-ends over the port's engines.  `AsyncFrontEnd` is here
now; the sharded store and engine come with the multi-GPU slice."""
from repro_torch.serve.distributed.frontend import AsyncFrontEnd, FrontEndStats

__all__ = ["AsyncFrontEnd", "FrontEndStats"]
