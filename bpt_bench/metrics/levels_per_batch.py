"""BFS levels a batch: fused_expand launches (one a level, the program's
``ops.LAUNCHES``) over the batches the window sampled."""


def read(rec: dict):
    if not rec.get("levels") or not rec.get("batches"):
        return None
    return rec["levels"] / rec["batches"]
