"""How far a bf16 model's gradient through the flash kernels lies from the
same gradient through plain attention, by depth, beside a control that
adds only the kernels' one extra rounding.

    PYTHONPATH=src python scripts/torch_bf16_depth.py \
        [--arch phi-3-vision-4.2b:2,8,16,32 musicgen-medium:2,8,24,48]

On one card, for each arch (full width, the port's seeded init, its
patches or codebooks in) and each depth: one step's gradient on
``chip_smoke.py``'s bf16 batch (TRAIN_BF16_BATCH x TRAIN_BF16_SEQ tokens
of ``SyntheticLM(seed 3)``) three ways — attention through the kernels
(the wgmma forward, which rounds P to bf16 for P·V, and the wgmma
backward), through the plain version (float32 inside, bf16 out), and
through the plain version with P rounded to bf16 before P·V — and the
worst and median leaf of each pair's relative L2 difference.  The
control (plain with P in bf16 against plain) carries no kernel: where it
reaches ``chip_smoke.py``'s TRAIN_BF16_RTOL, the check cannot tell a
sound kernel at that depth.  Prints the card's name and power limit
first and one JSON line last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def plain_bf16_p(q, k, v, *, causal=True, scale=None, kv_offset=0):
    """Plain attention of (B, L, H, D) q over (B, Lk, KVH, D) k and v
    whose softmax P is rounded to bf16 before P·V, as the wgmma forward
    rounds it; float32 otherwise, out in q's dtype."""
    b, L, h, d = q.shape
    kvh = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, L, kvh, h // kvh, d)
    s = torch.einsum("blkgd,bmkd->bkglm", qf, k.float()) * scale
    if causal:
        keep = torch.ones(L, k.shape[1], dtype=torch.bool,
                          device=q.device).tril(kv_offset)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    o = torch.einsum("bkglm,bmkd->blkgd", p, v.float())
    return o.reshape(b, L, h, d).to(q.dtype)


def _gradient(params, cfg, batch, attention):
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.optim import adamw

    named = adamw.named(params)
    kernel = ops.flash_attention
    ops.flash_attention = attention
    try:
        return dict(zip(named, torch.autograd.grad(
            model.loss_fn(params, cfg, batch)[0], list(named.values()))))
    finally:
        ops.flash_attention = kernel


def _compare(got: dict, want: dict) -> dict:
    rel = {n: float((got[n].float() - w.float()).norm()
                    / w.float().norm().clamp_min(1e-30))
           for n, w in want.items()}
    worst = max(rel, key=rel.get)
    return {"worst_leaf": worst, "worst": rel[worst],
            "median": sorted(rel.values())[len(rel) // 2]}


def main(argv=None) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=[
        "phi-3-vision-4.2b:2,8,16,32", "musicgen-medium:2,8,24,48"],
        help="ARCH:DEPTH,DEPTH,...")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_depth: needs a CUDA GPU")
    print(cs._gpu_line(), flush=True)
    _build.build_all(("flash_attention", "flash_prefill_wgmma",
                      "flash_decode", "flash_attention_bwd",
                      "flash_bwd_wgmma"))
    dev = torch.device("cuda")
    rows = []
    for spec in args.arch:
        arch, depths = spec.split(":")
        for depth in map(int, depths.split(",")):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(registry.get(arch), num_layers=depth)
            params = model.trainable(model.init_params(cfg, 0, dev))
            batch = cs._train_batch(SyntheticLM(
                cfg, cs.TRAIN_BF16_BATCH, cs.TRAIN_BF16_SEQ, seed=3), 0, dev)
            kernels = _gradient(params, cfg, batch, ops.flash_attention)
            plain = _gradient(params, cfg, batch, ref.flash_attention_ref)
            control = _gradient(params, cfg, batch, plain_bf16_p)
            row = dict(arch=arch, layers=depth,
                       kernels_vs_plain=_compare(kernels, plain),
                       control_vs_plain=_compare(control, plain),
                       kernels_vs_control=_compare(kernels, control),
                       seconds=time.perf_counter() - t0)
            rows.append(row)
            print(f"[bf16 depth] {arch}, {depth} layers: " + "; ".join(
                f"{k.replace('_', ' ')} worst {v['worst_leaf']} "
                f"{v['worst']:.3e}, median {v['median']:.3e}"
                for k, v in row.items() if isinstance(v, dict))
                + f" (limit {cs.TRAIN_BF16_RTOL})", flush=True)
            del params, kernels, plain, control
            torch.cuda.empty_cache()
    out = {"gpu": cs._gpu_line(), "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
