"""Distributed influence-query serving (PyTorch port of
``repro.serve.distributed``), SPMD over a `distributed.comm.Mesh`:

* `ShardedSketchStore` — RRR sketch slots split over a mesh axis (rows
  over the model axis too), equal slot for slot to a one-device pool,
  per-shard memory budgets, restore onto any mesh shape;
* `DistributedQueryEngine` — each rank counts coverage over its block
  with the coverage kernel, one psum merges; drop-in for `QueryEngine`
  under `MicroBatcher`;
* `AsyncFrontEnd` — the deadline-batched front end, over any engine;
* `MeshLeader` / `follow` — the front end on a mesh: rank 0 runs it over a
  `MeshLeader`, which broadcasts each engine call before making it, and
  every other rank makes the same calls in `follow`.
"""
from repro_torch.serve.distributed.engine import DistributedQueryEngine
from repro_torch.serve.distributed.frontend import AsyncFrontEnd, FrontEndStats
from repro_torch.serve.distributed.mesh_frontend import (MeshLeader,
                                                         MeshStats, follow)
from repro_torch.serve.distributed.sharded_store import ShardedSketchStore

__all__ = ["AsyncFrontEnd", "DistributedQueryEngine", "FrontEndStats",
           "MeshLeader", "MeshStats", "ShardedSketchStore", "follow"]
