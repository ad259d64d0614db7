"""Rank processes for the mesh paths (the port's counterpart of
``repro.launch.accel``, whose forced host devices give one process a
mesh: here a mesh of D·M positions is D·M processes).

`spawn` starts ``world`` processes by the ``spawn`` start method, puts
them in one default group (``backend`` gloo or nccl) through a ``file://``
rendezvous in a fresh temporary directory (so concurrent test workers
never meet on a port), runs ``fn(rank, device, *args)`` in each, and
returns the results in rank order.  Each rank runs ``torch`` on one thread
and binds ``device``: ``"cpu"``, or ``"cuda"``, which gives rank ``r`` card
``r mod count`` (every rank card 0 on a one-card machine).  ``fn`` must be
importable by its module path from a fresh interpreter: a function of this
package, never one of a script run as ``__main__``.

The run sits under ``timeout_s``: the default group's timeout bounds every
collective, and the parent joins under the same deadline, kills every
rank still running when it passes, and re-raises the first failure with
the rank's traceback.  Before a CUDA world starts, the parent builds the
kernels the ranks launch, so the ranks never build them at once, and
returns its cached device memory to the card.
"""
from __future__ import annotations

import datetime
import gc
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve

# The kernels the mesh paths launch (`distributed.traversal`, the
# distributed engine), built in the parent before a CUDA world starts.
MESH_KERNELS = ("fused_expand", "lt_select_expand", "coverage")


def rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(fn, rank, world, backend, device, init_file, timeout_s,
               args, results, env):
    os.environ.update(env)           # before the rank's first CUDA call
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:          # reported to the parent, which re-raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, *, args=(), backend: str = "gloo",
          device: str = "cuda", timeout_s: float = 600.0,
          kernels=MESH_KERNELS, env=None) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` ranks in one process
    group; returns the results by rank (see module docstring).  The ranks
    run on the card unless the caller asks for ``device="cpu"``; on the
    card the parent first builds ``kernels`` (by default the mesh paths'
    ones; training's are `launch.train.TRAIN_KERNELS`).  ``env``: variables
    each rank sets before anything else (the parent's own are left as
    they are)."""
    if resolve(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(kernels)
        gc.collect()
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, device,
                               os.path.join(tmp, "rendezvous"), timeout_s,
                               tuple(args), results, dict(env or {})))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    out: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead and results.empty():
                    raise RuntimeError(f"rank {dead[0]} of {world} exited "
                                       f"with code {procs[dead[0]].exitcode} "
                                       "before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within "
                                       f"{timeout_s:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
