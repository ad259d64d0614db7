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

``args`` reach the ranks through a file in that directory, not through
the pipe that starts each process: a pipe holds 64 KiB, and a process
reads the rest only after its interpreter has imported the parent's
main module and torch, so larger arguments would start the ranks one
after another.

`start` starts the same world and returns at once: its `World` handle's
``join`` waits for the results (`spawn` is ``start(...).join()``), so the
parent can do host work of its own while the ranks run.  After the join,
``World.timing`` says where each rank's start went, on the host's wall
clock from the moment the parent started the processes (the latest rank
of each): ``enter_s`` until the rank's first line ran (the interpreter
and the imports that unpickling ``fn`` and ``args`` pulled in),
``device_s`` until its device was bound (a CUDA context made), ``group_s``
until the default group was up (``fn`` then starts), ``run_s`` the
longest ``fn``, and ``world_s`` the whole, until the last result came.
"""
from __future__ import annotations

import datetime
import gc
import multiprocessing as mp
import os
import pickle
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
               args_file, results, env):
    t_enter = time.time()
    os.environ.update(env)           # before the rank's first CUDA call
    with open(args_file, "rb") as f:
        args = pickle.load(f)
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)   # the context, timed apart
    t_device = time.time()
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        t_group = time.time()
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out, (t_enter, t_device, t_group,
                                       time.time())))
    except BaseException:          # reported to the parent, which re-raises
        results.put((rank, False, traceback.format_exc(), None))
        raise


class World:
    """A world started by `start`: ``join`` returns the ranks' results in
    rank order (module docstring); ``timing`` holds where the start went
    once it has."""

    def __init__(self, fn, world: int, args, backend: str, device: str,
                 timeout_s: float, env):
        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        args_file = os.path.join(self._tmp, "args.pickle")
        with open(args_file, "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world, backend, device,
                  os.path.join(self._tmp, "rendezvous"), timeout_s,
                  args_file, self._results, dict(env or {})))
            for r in range(world)]
        self.timing: dict = {}
        self._t0 = time.time()
        self._deadline = time.monotonic() + timeout_s
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._close()
            raise

    def join(self) -> list:
        world, procs = self.world, self._procs
        out: dict[int, object] = {}
        stamps: dict[int, tuple] = {}
        try:
            while len(out) < world:
                try:
                    rank, ok, value, times = self._results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead and self._results.empty():
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} before reporting")
                    if time.monotonic() > self._deadline:
                        raise TimeoutError(f"{world} ranks did not finish "
                                           f"within {self.timeout_s:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                out[rank], stamps[rank] = value, times
            t_end = time.time()
            for p in procs:
                p.join(max(self._deadline - time.monotonic(), 1.0))
        finally:
            self._close()
        first = [[t - self._t0 for t in stamps[r]] for r in range(world)]
        self.timing = dict(
            enter_s=max(f[0] for f in first),
            device_s=max(f[1] for f in first),
            group_s=max(f[2] for f in first),
            run_s=max(f[3] - f[2] for f in first),
            world_s=t_end - self._t0)
        return [out[r] for r in range(world)]

    def _close(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        self._results.close()
        shutil.rmtree(self._tmp, ignore_errors=True)


def start(fn, world: int, *, args=(), backend: str = "gloo",
          device: str = "cuda", timeout_s: float = 600.0,
          kernels=MESH_KERNELS, env=None) -> World:
    """Start ``fn(rank, device, *args)`` on ``world`` ranks in one process
    group and return its `World` at once (module docstring).  The ranks
    run on the card unless the caller asks for ``device="cpu"``; on the
    card the parent first builds ``kernels`` (by default the mesh paths'
    ones; training's are `launch.train.TRAIN_KERNELS`).  ``env``:
    variables each rank sets before anything else (the parent's own are
    left as they are)."""
    if resolve(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(kernels)
        gc.collect()
        torch.cuda.empty_cache()
    return World(fn, world, args, backend, device, timeout_s, env)


def spawn(fn, world: int, *, args=(), backend: str = "gloo",
          device: str = "cuda", timeout_s: float = 600.0,
          kernels=MESH_KERNELS, env=None) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` ranks in one process
    group; returns the results by rank (`start`, then `World.join`)."""
    return start(fn, world, args=args, backend=backend, device=device,
                 timeout_s=timeout_s, kernels=kernels, env=env).join()
