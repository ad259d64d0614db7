"""The system under test: the port's pool, sampler and query front, built
from the benchmark's inputs, with the counters the benchmark reads.

This is the only file of the harness that imports the program
(``repro_torch``).  It builds a ``SketchStore`` on the ``kernel`` sampler
backend from the configuration, and a ``QueryEngine`` behind a
``MicroBatcher`` with a ``ResultCache``, as the launcher does.
"""
from __future__ import annotations

from repro_torch.graph import csr
from repro_torch.kernels import ops
from repro_torch.sampling import SamplerSpec
from repro_torch.serve.influence import (MicroBatcher, PoolConfig,
                                         QueryEngine, ResultCache,
                                         SketchStore)


def spec(config: dict, seed: int) -> SamplerSpec:
    """The configuration's sampler: its diffusion, backend, colours and
    level cap, the rest at their defaults; the master seed is the run's
    seed."""
    return SamplerSpec(diffusion=config["diffusion"],
                       backend=config["backend"],
                       num_colors=int(config["num_colors"]),
                       max_iters=int(config["max_levels"]),
                       master_seed=int(seed))


def store(edges, config: dict, seed: int, pool_batches: int, device
          ) -> SketchStore:
    """A pool of ``pool_batches`` batches on ``edges`` (deduped, sorted by
    (src, dst)), sampled."""
    g = csr.from_edges(edges.src, edges.dst, edges.prob, edges.num_vertices,
                       device=device)
    s = SketchStore(g, PoolConfig(max_batches=pool_batches,
                                  spec=spec(config, seed)))
    s.ensure(pool_batches)
    return s


def query_front(pool: SketchStore, query_slots: int, max_seeds: int,
                cache_capacity: int) -> MicroBatcher:
    engine = QueryEngine(pool, query_slots=query_slots, max_seeds=max_seeds)
    return MicroBatcher(engine, cache=ResultCache(cache_capacity))


def launches(kernel: str) -> int:
    """Kernel launches so far (``kernels.ops.LAUNCHES``)."""
    return ops.LAUNCHES[kernel]
