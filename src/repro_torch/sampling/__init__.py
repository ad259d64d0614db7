"""Sampling facade: one typed traversal spec over the port's backends.

    from repro_torch import sampling

    spec    = sampling.SamplerSpec(backend="kernel", num_colors=64)
    sampler = sampling.make_sampler(graph, spec)
    batch   = sampler.sample(0)                  # one rrr.RRRBatch
"""
from repro_torch.sampling.sampler import Sampler, make_sampler
from repro_torch.sampling.spec import (BACKENDS, DIFFUSIONS, FRONTIERS,
                                       SamplerSpec, resolve_spec, supported)

__all__ = ["BACKENDS", "DIFFUSIONS", "FRONTIERS", "Sampler", "SamplerSpec",
           "make_sampler", "resolve_spec", "supported"]
