"""Multi-GPU layers of the port on ``torch.distributed``: the SPMD mesh
(`comm`) and the sample- and graph-parallel traversals (`traversal`)."""
