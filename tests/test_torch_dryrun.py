"""`launch.dryrun` (the port's production dry-run on meta tensors)
against the reference's ``repro.launch.dryrun``.

* ``lower_cell`` for llama3.2-3b, deepseek-v3, zamba2, mamba2 and
  musicgen × train, prefill and decode at `tests/launch_check.py`'s smoke
  settings on a 1×1 `comm.ShapeMesh`, against the reference's
  ``lower_cell`` on a 1×1 mesh with ``Auto`` axes, run in one subprocess
  (`tests/torch_dryrun_reference.py`: importing ``repro.launch.dryrun``
  forces 512 host devices): FLOPs within 2% once the attention products,
  where the two do different work, are taken out of both sides by
  formula (`_attention_flops`).  The reference's blocked scan computes
  every (query block, key block) pair and, for MLA, projects each key
  block once per query block; the port's flash kernels attend only the
  visible (query, key) pairs, counted here by formula (4·D a pair
  forward, 10·D backward) and held equal to the work they report, and
  its MLA prefill
  skips the pairs that lie wholly past their queries and projects each key
  block once.  Training runs the attention forward twice (remat) and its
  gradient's two products for each forward product: four passes (the
  MLA projections as `_attention_flops` says).  The
  decode steps see every key (``cur_len = seq_len - 1``), so there the
  two agree without exception.
* ``_cell_skip_reason`` and ``roofline_terms`` equal the reference's,
  the latter given the reference's own rates (which the subprocess
  reads).
* On 2×2, the dry-run's collective counts by axis (``ShapeMesh.stats``
  of rank 0) of a smoke train step, prefill and decode step equal the
  real ``Mesh.stats`` of rank 0 running the same steps on 4 gloo CPU
  ranks (`torch_mesh_workers.dryrun_stats_world`), calls and bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import torch_mesh_workers as workers
from repro_torch.configs import registry
from repro_torch.distributed.comm import ShapeMesh
from repro_torch.launch import accel, dryrun
from repro_torch.models import model
from repro_torch.models.config import SHAPES, ShapeConfig

torch.set_num_threads(1)

ARCHS = ["llama3.2-3b", "deepseek-v3-671b", "zamba2-2.7b", "mamba2-1.3b",
         "musicgen-medium"]
CELLS = {"train": ShapeConfig("t", "train", 64, 8),
         "prefill": ShapeConfig("p", "prefill", 64, 4),
         "decode": ShapeConfig("d", "decode", 64, 8)}
FLOPS_RTOL = 0.02
_HERE = os.path.dirname(os.path.abspath(__file__))


def smoke_cfg(arch):
    return dataclasses.replace(registry.smoke(arch), num_patches=0,
                               attn_block_q=32, attn_block_k=32,
                               ssm_chunk=32)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_HERE, os.pardir, "src"))
    proc = subprocess.run([sys.executable, os.path.join(
        _HERE, "torch_dryrun_reference.py")], env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def _attention_layers(cfg) -> int:
    return sum(k not in ("mamba",) for k in model.layer_kinds(cfg)) \
        if cfg.family != "ssm" else 0


def _attention_flops(cfg, shape, kernels: dict) -> tuple[float, float]:
    """(the reference's, the port's) attention products of a train or
    prefill cell (module docstring)."""
    passes = 4 if shape.kind == "train" else 1
    b, L, h = shape.global_batch, shape.seq_len, cfg.num_heads
    n = _attention_layers(cfg)
    if cfg.attention != "mla":
        ref = n * passes * 2 * (2 * b * h * L * L * cfg.head_dim)
        # The flash kernels attend the L(L+1)/2 causal pairs: 4·D a pair
        # forward (QKᵀ, PV), 10·D backward (the five products of the
        # gradient); training runs the forward twice (remat).
        per_pair = 2 * 4 + 10 if shape.kind == "train" else 4
        port = n * per_pair * b * h * cfg.head_dim * L * (L + 1) // 2
        reported = sum(v["flops"] for k, v in kernels.items()
                       if k.startswith("flash_"))
        assert reported == port, (reported, port)
        return ref, port
    bq, bk = min(cfg.attn_block_q, L), min(cfg.attn_block_k, L)
    nq, nk = L // bq, L // bk
    vd = cfg.v_head_dim or cfg.head_dim
    pair = 2 * b * h * bq * bk * (cfg.head_dim + cfg.rope_head_dim + vd)
    proj = 2 * b * bk * cfg.kv_lora_rank * h * (cfg.head_dim + vd)
    seen = sum(j * bk <= (i + 1) * bq - 1 for i in range(nq)
               for j in range(nk))
    if shape.kind == "train":
        # The reference's compiled step projects each key block once a
        # forward pass (XLA hoists it out of the query-block loop) and
        # takes its gradient once a block pair; the port's blocked loop
        # does both once a key block.
        ref = n * (passes * nq * nk * pair + 2 * nk * proj
                   + 2 * nq * nk * proj)
        port = n * (passes * seen * pair + passes * nk * proj)
    else:
        ref = n * nq * nk * (pair + proj)
        port = n * (seen * pair + nk * proj)
    return ref, port


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_lower_cell_flops_match_the_reference(reference, arch, kind):
    want = reference["cells"][f"{arch}/{kind}"]
    assert want["status"] == "ok", want["error"]
    cfg, shape = smoke_cfg(arch), CELLS[kind]
    rec = dryrun.lower_cell(arch, kind, multi_pod=False, cfg=cfg,
                            mesh=ShapeMesh((1, 1), ("data", "model")),
                            shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    got = rec["flops_per_device"]
    ref = want["flops"]
    if kind != "decode":
        ref_attn, port_attn = _attention_flops(cfg, shape, rec["kernels"])
        ref, got = ref - ref_attn, got - port_attn
    assert abs(got - ref) <= FLOPS_RTOL * ref, (got, ref)
    assert rec["bytes_per_device"] > 0 and rec["peak_bytes"] > 0
    assert rec["fits"] and rec["microbatches"] == 1
    assert rec["roofline"]["compute_s"] > 0


def test_skip_reasons_and_roofline_equal_the_reference(reference):
    rates = reference["rates"]
    for arch in registry.ARCHS:
        cfg = registry.get(arch)
        for name, shape in SHAPES.items():
            key = f"{arch}/{name}"
            assert dryrun._cell_skip_reason(cfg, name) == \
                reference["skip"][key]
            for want, x in zip(reference["roofline"][key],
                               [(1.5e12, 3.0e10, 2.0e9, 256),
                                (4.0e9, 8.0e11, 0.0, 512)]):
                got = dryrun.roofline_terms(cfg, shape, *x, **rates)
                want["counted_flops_total"] = want.pop("hlo_flops_total")
                assert got == pytest.approx(want, rel=1e-12), key


def test_unsupported_and_rates():
    """train_4k on 2×16×16: 256 rows on 512 ranks split in no microbatch
    count; the card's rates by default; NVLink inside a node."""
    rec = dryrun.lower_cell("llama3.2-3b", "train_4k", multi_pod=True)
    assert rec["status"] == "unsupported"
    assert "512 ranks" in rec["reason"] and rec["chips"] == 512
    assert dryrun.microbatches("train_4k", 256, (16, 16)) == 1
    assert dryrun.microbatches("train_4k", 512, (8, 8)) == 8
    assert dryrun.axis_rate(ShapeMesh((2, 2), ("data", "model")),
                            "data") == dryrun.NVLINK_BW
    prod = ShapeMesh((16, 16), ("data", "model"))
    assert dryrun.axis_rate(prod, "model") == dryrun.IB_BW
    assert dryrun.axis_rate(prod, "data") == dryrun.IB_BW
    assert dryrun.axis_rate(ShapeMesh((2, 8), ("data", "model")),
                            "model") == dryrun.NVLINK_BW


STATS_ARCHS = ["llama3.2-3b", "zamba2-2.7b", "deepseek-v3-671b"]
TRAIN, SERVE = (8, 32), (4, 32, 68)


@pytest.fixture(scope="module")
def real_stats():
    cfgs = [registry.smoke(a) for a in STATS_ARCHS]
    return accel.spawn(workers.dryrun_stats_world, 4, args=(
        cfgs, TRAIN, SERVE), device="cpu", timeout_s=600)[0]


@pytest.mark.parametrize("arch", STATS_ARCHS)
def test_dry_stats_equal_the_real_mesh(real_stats, arch):
    cfg = registry.smoke(arch)
    real = real_stats[STATS_ARCHS.index(arch)]
    cells = {"train": ShapeConfig("t", "train", TRAIN[1], TRAIN[0]),
             "prefill": ShapeConfig("p", "prefill", SERVE[1], SERVE[0]),
             "decode": ShapeConfig("d", "decode", SERVE[2], SERVE[0])}
    for kind, shape in cells.items():
        rec = dryrun.lower_cell(arch, kind, multi_pod=False, cfg=cfg,
                                mesh=ShapeMesh((2, 2), ("data", "model")),
                                shape=shape)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["collective"]["by_axis"] == real[kind], kind


@pytest.mark.parametrize("which", ["sample", "graph", "graph_q"])
def test_bpt_cells_trace_one_level(which):
    """The paper's workloads at the reference's sizes: one level through
    the tile kernel's meta branch (graph, graph_q: the frontier's
    all-gather and the control pmax over ``model``) or the CSR sweep
    (sample: no collective, the graph replicated)."""
    rec = dryrun.lower_bpt_cell(which, multi_pod=False,
                                mesh=ShapeMesh((2, 4), ("data", "model")))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["levels_traced"] == 1 and rec["chips"] == 8
    by_axis = rec["collective"]["by_axis"]
    if which == "sample":
        assert rec["kernels"] == {} and by_axis["model"]["calls"] == 0
        assert rec["bytes_per_device"] > 68_993_773 * 16 * 4
    else:
        name = "fused_expand" if which == "graph" else "fused_expand_q"
        assert list(rec["kernels"]) == [name]
        assert rec["kernels"][name]["calls"] == 1
        # The pmax's int64 count and the shard's (rows, 2) frontier words:
        # 5,354 row blocks of 128 padded to 5,356, 1,339 a shard.
        rows = 5356 // 4 * 128
        assert by_axis == {"data": {"calls": 0, "bytes": 0},
                           "model": {"calls": 2, "bytes": 8 + rows * 2 * 4}}
        assert rec["collective"]["op_counts"] == {"all-reduce": 1,
                                                  "all-gather": 1}
        assert rec["fits"]
