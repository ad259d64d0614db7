"""The reference's dry-run at the launch tests' smoke settings, for
`test_torch_dryrun.py`: run in a subprocess of its own, because importing
``repro.launch.dryrun`` forces 512 host devices through ``XLA_FLAGS``.

Prints one JSON object: each cell's ``lower_cell`` FLOPs and status on a
1×1 mesh with ``Auto`` axes (a mesh that ``jax.make_mesh`` makes with
``Explicit`` axes fails there under jax 0.9), the module's rates,
``_cell_skip_reason`` for every arch × shape, and ``roofline_terms`` of
a few inputs."""
import dataclasses
import json
import sys

from repro.launch import dryrun  # sets XLA_FLAGS before jax starts

import jax  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.models.config import SHAPES, ShapeConfig  # noqa: E402

ARCHS = ["llama3.2-3b", "deepseek-v3-671b", "zamba2-2.7b", "mamba2-1.3b",
         "musicgen-medium"]
CELLS = {"train": ShapeConfig("t", "train", 64, 8),
         "prefill": ShapeConfig("p", "prefill", 64, 4),
         "decode": ShapeConfig("d", "decode", 64, 8)}
ROOFLINE_INPUTS = [(1.5e12, 3.0e10, 2.0e9, 256), (4.0e9, 8.0e11, 0.0, 512)]


def smoke_cfg(arch):
    return dataclasses.replace(registry.smoke(arch), num_patches=0,
                               attn_block_q=32, attn_block_k=32,
                               ssm_chunk=32)


def main():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {"cells": {}, "rates": {"peak_flops": dryrun.PEAK_FLOPS,
                                  "hbm_bw": dryrun.HBM_BW,
                                  "coll_bw": dryrun.ICI_BW},
           "skip": {}, "roofline": {}}
    for arch in ARCHS:
        cfg = smoke_cfg(arch)
        for kind, shape in CELLS.items():
            rec = dryrun.lower_cell(arch, kind, multi_pod=False, cfg=cfg,
                                    mesh=mesh, shape=shape)
            out["cells"][f"{arch}/{kind}"] = {
                "status": rec["status"], "error": rec.get("error"),
                "flops": rec.get("flops_per_device")}
    for arch in registry.ARCHS:
        cfg = registry.get(arch)
        for name, shape in SHAPES.items():
            out["skip"][f"{arch}/{name}"] = dryrun._cell_skip_reason(cfg,
                                                                     name)
            out["roofline"][f"{arch}/{name}"] = [
                dryrun.roofline_terms(cfg, shape, *x)
                for x in ROOFLINE_INPUTS]
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    main()
