"""Online influence-query serving: sketch pool + batched query engine.

    store   = SketchStore(graph, PoolConfig(num_colors=64, max_batches=32))
    store.ensure(16)                          # sample 16 fused batches
    engine  = QueryEngine(store)
    batcher = MicroBatcher(engine, cache=ResultCache())
    t0 = batcher.submit_top_k(8)
    t1 = batcher.submit_sigma([3, 17, 42])
    t2 = batcher.submit_marginal(exclude=[3, 17])
    results = batcher.flush()
"""
from repro_torch.sampling import SamplerSpec
from repro_torch.serve.influence.batcher import FlushError, MicroBatcher
from repro_torch.serve.influence.cache import ResultCache
from repro_torch.serve.influence.engine import QueryEngine
from repro_torch.serve.influence.sketch_store import PoolConfig, SketchStore

__all__ = ["FlushError", "MicroBatcher", "PoolConfig", "QueryEngine",
           "ResultCache", "SamplerSpec", "SketchStore"]
