"""Production dry-run: trace every (arch × shape) cell on the production
mesh, one rank's program on meta tensors (the port's counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each cell for the 16×16 and 2×16×16
meshes of 256 and 512 placeholder devices.  The port runs one process a
mesh position, so the dry-run traces rank 0's own program on a
`distributed.comm.ShapeMesh` of the production shape (no process group,
no card): its collectives return meta tensors and count what a real
mesh's would.  Per cell this gives, without allocating a model byte:

* proof that the sharded program runs at that size (no shape error, no
  split that does not divide), or the reason it cannot
  (``unsupported``);
* the per-device peak of live tensor bytes (does it fit the card?),
* FLOPs and HBM bytes, and collective bytes by kind and by axis
  (`launch.cost_analysis`), for the roofline terms.

Cells: train is one step of `train.step.make_train_step` on the mesh
(ZeRO-3 shards of the parameters and moments, the reference's
microbatches where they split over the ranks); prefill is
`serve.engine.prefill` on the mesh, decode one sequence-parallel
`models.decode.decode_step` at ``cur_len = seq_len - 1`` (the step that
sees every key).  The BPT cells (`lower_bpt_cell`) trace one level of the
paper's traversal (module docstring of `launch.cost_analysis`: a level
loop ends on data, which meta tensors lack).  Records go under ``--out``
(default ``dryrun_out/`` at the repository's root), one JSON file a cell.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--bpt]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.distributed import fsdp
from repro_torch.distributed.comm import ShapeMesh
from repro_torch.launch import cost_analysis, specs
from repro_torch.launch.mesh import production_shape
from repro_torch.models import decode as dec
from repro_torch.models import model
from repro_torch.models.config import LONG_CONTEXT_FAMILIES, SHAPES
from repro_torch.serve import engine
from repro_torch.train.step import make_train_step

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak, HBM3 rate,
# 32-bit operations outside the tensor cores (the BPT cells' integer
# work); NVLink 4 (one direction, a GPU) inside an 8-GPU node, NDR
# InfiniBand (400 Gb/s a GPU) between nodes.
CARD = "NVIDIA H100 SXM5"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
SCALAR_OPS = 67e12
NVLINK_BW = 450e9
IB_BW = 50e9
GPUS_PER_NODE = 8
HBM_BYTES = 79.18 * 2 ** 30          # what a card offers a process

TRAIN_MICROBATCHES = {"train_4k": 8}


class Unsupported(Exception):
    """A cell the port's sharded program cannot run (its reason)."""


def _cell_skip_reason(cfg, shape_name: str):
    if shape_name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return ("full-attention arch: 512K decode requires sub-quadratic "
                "sequence mixing (DESIGN.md §5)")
    return None


def microbatches(shape_name: str, batch: int, mesh_shape) -> int:
    """The reference's microbatch count where each microbatch splits over
    the mesh's ranks (`fsdp.check_rows`), else the largest count below it
    that does; raises `Unsupported` with ``check_rows``'s message where
    none does."""
    want = TRAIN_MICROBATCHES.get(shape_name, 1)
    for m in range(want, 0, -1):
        try:
            fsdp.check_rows(batch, m, mesh_shape)
            return m
        except ValueError as e:
            if m == want:
                first = e
    raise Unsupported(str(first))


def axis_rate(mesh, axis: str, nvlink_bw: float = NVLINK_BW,
              ib_bw: float = IB_BW) -> float:
    """The link rate of ``axis``: NVLink where the ranks of rank 0's line
    along it share an 8-GPU node (ranks are numbered row-major, as
    `comm.Mesh` numbers them), InfiniBand where they span nodes."""
    names = list(mesh.axis_names)
    stride = math.prod(mesh.shape[a] for a in names[names.index(axis) + 1:])
    span = (mesh.shape[axis] - 1) * stride
    return nvlink_bw if span < GPUS_PER_NODE else ib_bw


def collective_seconds(mesh, **rates) -> float:
    """The collectives' time on each axis's link: result bytes times the
    reference's factor, over `axis_rate`."""
    total = 0.0
    for kind, axes in mesh.collective_log.items():
        factor = cost_analysis.FACTOR.get(cost_analysis.KINDS[kind], 1.0)
        for axis, v in axes.items():
            total += factor * v["bytes"] / axis_rate(mesh, axis, **rates)
    return total


def roofline_terms(cfg, shape, flops_dev, bytes_dev, coll_dev, chips, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   coll_bw: float = IB_BW) -> dict:
    """The reference's three terms and their bound, at the rates given
    (the card's by default, module constants)."""
    t_compute = flops_dev / peak_flops
    t_memory = bytes_dev / hbm_bw
    t_collective = coll_dev / coll_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    n_active = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    total = flops_dev * chips
    terms.update(
        dominant=dominant.replace("_s", ""),
        model_flops=model_flops,
        counted_flops_total=total,
        useful_fraction=(model_flops / total) if total else None,
        bound_step_time_s=max(t_compute, t_memory, t_collective),
    )
    return terms


def _mesh_record(mesh) -> dict:
    chips = math.prod(mesh.shape.values())
    return {"mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
            "axes": list(mesh.axis_names), "chips": chips}


def _cost_fields(cost: dict) -> dict:
    peak = cost["peak_bytes"]
    return dict(
        flops_per_device=cost["flops"], bytes_per_device=cost["bytes"],
        collective=cost["collective"], kernels=cost["kernels"],
        memory={"argument_bytes": cost["argument_bytes"],
                "peak_bytes": peak},
        peak_bytes=peak, fits=peak <= HBM_BYTES)


def _sharded_params(cfg, mesh, trainable: bool = False):
    """This rank's meta shards of ``cfg``'s weights, their layout
    attached."""
    layout = model.layout_on(mesh, cfg)
    params = layout.attach(model.init_params(cfg, device="meta",
                                             keep=layout.local))
    return model.trainable(params) if trainable else params


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, cfg=None,
               mesh=None, shape=None) -> dict:
    """Trace one cell (module docstring); ``cfg`` / ``mesh`` / ``shape``
    overrides run the same code at another size (a `ShapeMesh` of any
    shape)."""
    cfg = cfg or registry.get(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or ShapeMesh(*production_shape(multi_pod))
    record = {"arch": arch, "shape": shape_name, **_mesh_record(mesh),
              "kind": shape.kind}
    skip = _cell_skip_reason(cfg, shape_name)
    if skip:
        record.update(status="skipped", reason=skip)
        return record
    try:
        t0 = time.perf_counter()
        m = 1
        if shape.kind == "train":
            m = microbatches(shape_name, shape.global_batch,
                             tuple(mesh.shape.values()))
            params = _sharded_params(cfg, mesh, trainable=True)
            opt = specs.opt_specs(cfg, params)
            batch = specs.batch_specs(cfg, shape)
            step = make_train_step(cfg, lambda s: 3e-4, num_microbatches=m,
                                   mesh=mesh)
            cost = cost_analysis.full_cost(step, params, opt, batch,
                                           mesh=mesh)
        elif shape.kind == "prefill":
            params = _sharded_params(cfg, mesh)
            batch = specs.batch_specs(cfg, shape, with_labels=False)
            with torch.no_grad():
                cost = cost_analysis.full_cost(
                    engine.prefill, params, cfg, batch, shape.seq_len, mesh,
                    mesh=mesh)
        else:
            params = _sharded_params(cfg, mesh)
            caches, tok, cur = specs.decode_specs(cfg, shape, mesh)
            with torch.no_grad():
                cost = cost_analysis.full_cost(
                    dec.decode_step, params, cfg, caches,
                    caches.layout.rows(tok), cur, mesh, mesh=mesh)
        trace_s = time.perf_counter() - t0
        coll = cost["collective"]["per_device_bytes"]
        coll_s = collective_seconds(mesh)
        record.update(
            status="ok", trace_s=trace_s, microbatches=m,
            **_cost_fields(cost),
            roofline=roofline_terms(
                cfg, shape, cost["flops"], cost["bytes"], coll,
                record["chips"],
                coll_bw=coll / coll_s if coll_s else IB_BW),
            card=CARD)
    except Unsupported as e:
        record.update(status="unsupported", reason=str(e))
    except Exception as e:                           # record the failure
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    return record


# ------------------------------------------------------------- BPT workloads
def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _csr_level(g, frontier, visited, seed: int, level: int):
    """One level of the CSR sweep (`core.traversal.fused_step`) with every
    edge live, the most a level can hash: its expansion
    (`core.traversal.expand_live`) over the whole edge list."""
    from repro_torch.core import traversal

    visited = visited | frontier
    fr_src = frontier[g.src.to(torch.int64)]
    live = torch.arange(g.num_edges, device=frontier.device)
    return traversal.expand_live(g, fr_src, visited, live, level,
                                 seed), visited


def _graph_level(slots, frontier_local, mesh, gate: str):
    """One level of `distributed.traversal.graph_parallel_traversal`'s
    loop: its control (`level_control`: the pmax over ``model``) and its
    dense level (`gather_level`: the frontier's all-gather, the shard's
    expansion through the tile kernel's wrapper)."""
    from repro_torch.distributed import traversal as dtraversal
    from repro_torch.kernels import ops

    kernel = ops.fused_expand_slots if gate == "ic" \
        else ops.fused_expand_q_slots

    def expand(fr_global, vis_local, level):
        return kernel(slots, fr_global, vis_local, 7, level)

    dtraversal.level_control(frontier_local, mesh, ("model",))
    fr, vis, _ = dtraversal.gather_level(
        expand, frontier_local, torch.zeros_like(frontier_local), 0, mesh,
        "model", mesh.shape["model"])
    return fr, vis


def lower_bpt_cell(which: str, *, multi_pod: bool, mesh=None) -> dict:
    """The paper's own workload on the production mesh, one level traced
    (module docstring), at the reference's sizes: ``sample`` —
    soc-LiveJournal1 (V 4,847,571, E 68,993,773), 512 colours, the graph
    replicated and one fused batch a rank (the CSR level of
    `distributed.traversal.sample_parallel_visited`); ``graph`` /
    ``graph_q`` — web-BerkStan (V 685,230, E 7,600,595), 64 colours, its
    rows over ``model`` in tiles of 128: a rank's slot list holds E/S
    entries over the reference's 1,900 tiles a shard, float32 (IC) or
    uint8 (quantised) values."""
    from repro_torch.core.tiles import SlotList
    from repro_torch.graph import csr

    mesh = mesh or ShapeMesh(*production_shape(multi_pod))
    record = {"arch": f"fused-bpt-{which}", "shape": which,
              **_mesh_record(mesh), "kind": "bpt", "levels_traced": 1}
    try:
        t0 = time.perf_counter()
        if which == "sample":
            v, e, c = 4_847_571, 68_993_773, 512
            g = csr.Graph(indptr=_meta((v + 1,)), src=_meta((e,)),
                          dst=_meta((e,)), prob=_meta((e,), torch.float32),
                          num_vertices=v, num_edges=e)
            w = c // 32
            with torch.no_grad():
                cost = cost_analysis.full_cost(
                    _csr_level, g, _meta((v, w)), _meta((v, w)), 7, 0,
                    mesh=mesh)
        elif which in ("graph", "graph_q"):
            v, e, c, t = 685_230, 7_600_595, 64, 128
            s = mesh.shape["model"]
            nb = -(-(-(-v // t)) // s) * s
            rows = nb // s * t
            tiles_per_shard, n = 1900, -(-e // s)
            value = (torch.float32 if which == "graph" else torch.uint8)
            slots = SlotList(slot_ptr=_meta((tiles_per_shard + 1,)),
                             src_row=_meta((n,)), dst_row=_meta((n,)),
                             value=_meta((n,), value), key=_meta((n,)),
                             src_rows=s * rows, dst_rows=rows)
            gate = "ic" if which == "graph" else "q"
            cost = cost_analysis.full_cost(
                _graph_level, slots, _meta((rows, c // 32)), mesh, gate,
                mesh=mesh)
        else:
            raise ValueError(f"no BPT cell {which!r}")
        coll_s = collective_seconds(mesh)
        roof = {"compute_s": cost["flops"] / SCALAR_OPS,
                "memory_s": cost["bytes"] / HBM_BW,
                "collective_s": coll_s}
        roof["dominant"] = max(roof, key=roof.get).replace("_s", "")
        roof["bound_step_time_s"] = max(roof["compute_s"], roof["memory_s"],
                                        roof["collective_s"])
        record.update(status="ok", trace_s=time.perf_counter() - t0,
                      **_cost_fields(cost), roofline=roof, card=CARD)
    except Exception as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    return record


def save_record(record: dict, tag: str = "", out=None) -> str:
    """Write ``record`` as JSON under ``out`` (default `RESULTS_DIR`)."""
    out = pathlib.Path(out) if out else RESULTS_DIR
    out.mkdir(parents=True, exist_ok=True)
    name = (f"dryrun_{record['arch']}_{record['shape']}_"
            f"{record['mesh']}{tag}.json")
    with open(out / name, "w") as f:
        json.dump(record, f, indent=1, default=str)
    return name


def summary(rec: dict) -> str:
    """One line for a record: status, dominant term, per-device GiB and
    whether it fits, or the reason."""
    if rec["status"] == "ok":
        return (f"ok       {rec['roofline']['dominant']:10s} "
                f"{rec['peak_bytes'] / 2 ** 30:9.2f} GiB "
                f"fits={rec['fits']} traced in {rec['trace_s']:.2f}s")
    return f"{rec['status']:8s} {rec.get('reason', rec.get('error', ''))}"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=registry.ARCHS + ["all"])
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--bpt", action="store_true",
                    help="trace the paper's fused-BPT workloads")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"records' directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    cells = []
    if args.bpt:
        for which in ("sample", "graph", "graph_q"):
            rec = lower_bpt_cell(which, multi_pod=args.multi_pod)
            print(f"[dryrun] {rec['arch']:28s} {which:12s} "
                  f"{rec['mesh']:9s} {summary(rec)}")
            save_record(rec, out=args.out)
            cells.append(rec)
        if not (args.all or args.arch):
            return cells
    archs = registry.ARCHS if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    for arch in archs:
        for shape in shapes:
            rec = lower_cell(arch, shape, multi_pod=args.multi_pod)
            print(f"[dryrun] {arch:28s} {shape:12s} {rec['mesh']:9s} "
                  f"{summary(rec)}")
            save_record(rec, out=args.out)
            cells.append(rec)
    count = {s: sum(c["status"] == s for c in cells)
             for s in ("ok", "skipped", "unsupported", "error")}
    print("[dryrun] " + " / ".join(f"{n} {s}" for s, n in count.items())
          + f" of {len(cells)}")
    return cells


if __name__ == "__main__":
    main()
