"""Where a world of ranks on one host spends its start, and what a gloo
collective and the host staging cost there.

    PYTHONPATH=src python scripts/torch_spawn_probe.py [--device cuda]
        [--sizes 1 16 64] [--out FILE]

Starts, one after the other, a 4-rank gloo world (`launch.accel.start`),
the same world with each rank's ``GLOO_SOCKET_IFNAME=lo`` (gloo's sockets
on the loopback device, where by default it takes the device the host's
name resolves to), and on the card a 1-rank NCCL world; each runs
`launch.mesh_smoke.rank_transport_probe` on host tensors of ``--sizes``
MiB a rank.  Prints per world `World.timing` (the rank start's parts on
the host's wall clock) and per size the worst rank's all-gather and
all-to-all ms with the implied GB/s a rank receives, and the
device-to-host and host-to-device copy ms (pageable and pinned).  The
card's name and power limit head the output on the card; one JSON line
ends it (and goes to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _world(name, world, backend, device, sizes, env=None) -> dict:
    from repro_torch.launch import accel, mesh_smoke

    w = accel.start(mesh_smoke.rank_transport_probe, world,
                    args=(sizes,), backend=backend, device=device,
                    timeout_s=300, kernels=(), env=env)
    ranks = w.join()
    rows = []
    for i, size in enumerate(sizes):
        worst = {k: max(r["sizes"][i][k] for r in ranks)
                 for k in ranks[0]["sizes"][i] if k.endswith("_ms")}
        recv = size * (world - 1)
        worst["all_gather_gb_s"] = recv / worst["all_gather_ms"] / 1e6
        worst["all_to_all_gb_s"] = (recv * (world - 1) // world
                                    / worst["all_to_all_ms"] / 1e6)
        rows.append(dict(bytes=size, **worst))
    out = dict(name=name, world=world, backend=backend, env=env or {},
               timing=w.timing, sizes=rows)
    print(f"[probe] {name}: start " + ", ".join(
        f"{k} {v:.2f}" for k, v in w.timing.items()) + "; " + "; ".join(
        f"{r['bytes'] >> 20} MiB all_gather {r['all_gather_ms']:.1f} ms "
        f"({r['all_gather_gb_s']:.2f} GB/s in), all_to_all "
        f"{r['all_to_all_ms']:.1f} ms"
        + (f", d2h {r['d2h_pageable_ms']:.2f} / {r['d2h_pinned_ms']:.2f}, "
           f"h2d {r['h2d_pageable_ms']:.2f} / {r['h2d_pinned_ms']:.2f} ms "
           "(pageable / pinned)" if "d2h_pinned_ms" in r else "")
        for r in rows), flush=True)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 16, 64],
                    help="MiB a rank")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_spawn_probe: no CUDA GPU", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    sizes = [m << 20 for m in args.sizes]
    worlds = [_world("gloo 4", 4, "gloo", args.device, sizes),
              _world("gloo 4 on lo", 4, "gloo", args.device, sizes,
                     {"GLOO_SOCKET_IFNAME": "lo"})]
    if args.device == "cuda":
        worlds.append(_world("nccl 1", 1, "nccl", args.device, sizes[:1]))
    line = json.dumps({"worlds": worlds})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
