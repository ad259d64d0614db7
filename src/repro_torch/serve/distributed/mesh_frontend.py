"""The async front end on a mesh: SPMD ranks led by rank 0 (the port's
form of the reference's single-controller ``_async_demo`` over a
``DistributedQueryEngine``; the same front end and the same answers, only
who starts each dispatch differs).

The reference has one controller that maps each query program over the
mesh.  Here every mesh position is a process, and every rank must make
the same `DistributedQueryEngine` calls in the same order.  Rank 0 owns
the request queue and the deadline clock: it runs `AsyncFrontEnd` over a
`MeshLeader`, which has the engine's surface as `MicroBatcher` uses it.
Before each engine call the leader broadcasts one fixed-size int32 message
over the whole mesh (`Mesh.broadcast` with ``axes``): the opcode, its
scalars (a refresh fraction as its float64 bits) and the padded
``(query_slots, max_seeds)`` seeds and mask.  Every other rank runs
`follow`: receive, make the same call on its own block of the pool, and
return on ``STOP``.

    # rank 0                                  # every other rank
    with MeshLeader(engine) as leader:        follow(engine)
        fe = AsyncFrontEnd(MicroBatcher(leader, cache=ResultCache()))
        fe.submit_sigma([3, 17]).result()
        fe.close()
    # leaving the block broadcasts STOP

* **One caller.**  Every collective of rank 0 goes through the leader's
  lock: the front end's dispatcher and refresher (which also hold its
  dispatch lock) and the keepalive.  No other thread of rank 0 may call
  the engine, its store or the mesh while the leader is open; direct
  calls wait until after ``STOP``, on every rank in the same order.
* **Rank 0 only.**  The cache lives on rank 0: a hit broadcasts nothing.
  Padding and deduplication happen on rank 0 before the broadcast, so
  every message has one shape; a follower never pads.
* **The refresh** goes through the leader's ``store``, whose ``refresh``
  broadcasts ``REFRESH`` first, so it lands in order with the flushes on
  every rank.  No other store call can be broadcast: the leader's store
  refuses it, and with it ``AsyncFrontEnd.mutate_store`` of any other
  function (the serving tier's path, which stays refused on a mesh).
* **Idle.**  A follower waits inside a broadcast, which the group's
  timeout bounds.  The leader sends ``NOOP`` after ``keepalive_s`` without
  a message, so ``keepalive_s`` must sit well under that timeout (half of
  it at most: a keepalive may come up to a quarter of ``keepalive_s``
  late).
* **Failures.**  A submit that fails validation (an oversized seed set)
  raises on its caller's thread on rank 0 and broadcasts nothing.  A call
  that raises on one rank after its broadcast leaves the other ranks
  inside a collective: the world fails within the group's timeout, and
  the failure is never hidden.  Every future on rank 0 still resolves,
  with the dispatch's `FlushError` or with ``close()``'s.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.serve.influence import engine as engine_lib

TOP_K, SIGMA, MARGINAL, REFRESH, NOOP, STOP = range(6)
OPS = ("top_k", "sigma", "marginal", "refresh", "noop", "stop")
_HEADER = 4     # opcode, count (k or real query slots), float64 bits × 2


@dataclasses.dataclass
class MeshStats:
    """One rank's side of a led session: the messages by opcode, and per
    engine call in order its opcode and host seconds (the leader's from
    the start of its broadcast, a follower's from the message's arrival,
    to the result on the host)."""
    messages: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(OPS, 0))
    dispatches: list = dataclasses.field(default_factory=list)


def message_size(engine) -> int:
    """int32 words of one message for ``engine``'s slot shape."""
    return _HEADER + 2 * engine.query_slots * engine.max_seeds


def _encode(engine, op: int, count: int = 0, fraction: float = 0.0,
            seeds=None, mask=None) -> torch.Tensor:
    msg = torch.zeros(message_size(engine), dtype=torch.int32)
    msg[0], msg[1] = op, count
    msg[2:4] = torch.from_numpy(np.array([fraction]).view(np.int32))
    if seeds is not None:
        qs = engine.query_slots * engine.max_seeds
        msg[_HEADER:_HEADER + qs] = seeds.reshape(-1).to(torch.int32)
        msg[_HEADER + qs:] = mask.reshape(-1).to(torch.int32)
    return msg


def _run(engine, msg: torch.Tensor):
    """The engine call ``msg`` names, on this rank's block."""
    op, count = int(msg[0]), int(msg[1])
    if op == TOP_K:
        return engine.top_k(count)
    if op == REFRESH:
        return engine.store.refresh(
            float(msg[2:4].numpy().view(np.float64)[0]))
    if op not in (SIGMA, MARGINAL):
        raise ValueError(f"no engine call for opcode {op}")
    q, s = engine.query_slots, engine.max_seeds
    seeds = msg[_HEADER:_HEADER + q * s].reshape(q, s).to(torch.int64)
    mask = msg[_HEADER + q * s:].reshape(q, s).to(torch.bool)
    seeds, mask = seeds.to(engine.device), mask.to(engine.device)
    if op == SIGMA:
        return engine.sigma_padded(seeds, mask)[:count]
    return engine.marginal_padded(seeds, mask)


class _LeaderStore:
    """The engine's store as rank 0's front end sees it: reads pass
    through, ``refresh`` is broadcast, any other call is refused."""

    def __init__(self, leader: "MeshLeader"):
        self._leader = leader

    def refresh(self, fraction: float = 0.25) -> list[int]:
        return self._leader._call(REFRESH, fraction=fraction)

    def __getattr__(self, name):
        value = getattr(self._leader.engine.store, name)
        if callable(value):
            raise RuntimeError(
                f"store.{name} cannot be broadcast to the other ranks of "
                "the mesh: only refresh is")
        return value


class MeshLeader:
    """Rank 0's `DistributedQueryEngine` for `MicroBatcher`: each call is
    broadcast to the followers, then made here (see module docstring)."""

    def __init__(self, engine, *, keepalive_s: float = 60.0):
        if engine.mesh.rank != 0:
            raise ValueError("the leader runs on rank 0; every other rank "
                             "runs follow(engine)")
        self.engine = engine
        self.query_slots = engine.query_slots
        self.max_seeds = engine.max_seeds
        self.keepalive_s = keepalive_s
        self.store = _LeaderStore(self)
        self.stats = MeshStats()
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._closed = False
        self._stop = threading.Event()
        self._keepalive = threading.Thread(
            target=self._keepalive_loop, daemon=True, name="mesh-keepalive")
        self._keepalive.start()

    def _call(self, op: int, **kw):
        with self._lock:
            return self._send(op, **kw)

    def _send(self, op: int, **kw):
        """Broadcast one message, then make its call here (lock held)."""
        if self._closed:
            raise RuntimeError("MeshLeader is closed")
        t0 = time.perf_counter()
        mesh = self.engine.mesh
        msg = mesh.broadcast(_encode(self.engine, op, **kw),
                             axes=mesh.axis_names)
        self._last = time.monotonic()
        self.stats.messages[OPS[op]] += 1
        if op in (NOOP, STOP):
            return None
        out = _run(self.engine, msg)
        self.stats.dispatches.append((OPS[op], time.perf_counter() - t0))
        return out

    def _keepalive_loop(self) -> None:
        while not self._stop.wait(self.keepalive_s / 4):
            with self._lock:
                if self._closed:
                    return
                if time.monotonic() - self._last >= self.keepalive_s:
                    self._send(NOOP)

    # ------------------------------------------- QueryEngine's surface
    def pad(self, seed_sets):
        """Host ``(Q, S)`` seeds and mask: padded here, before a
        broadcast, so every message has one shape."""
        return engine_lib.pad_queries(seed_sets, self.query_slots,
                                      self.max_seeds, "cpu")

    def top_k(self, k: int):
        return self._call(TOP_K, count=int(k))

    def sigma(self, seed_sets) -> np.ndarray:
        seeds, mask = self.pad(seed_sets)
        return self._call(SIGMA, count=len(seed_sets), seeds=seeds,
                          mask=mask)

    def marginal_padded(self, excl_seeds, excl_mask) -> np.ndarray:
        return self._call(MARGINAL, seeds=excl_seeds, mask=excl_mask)

    # ------------------------------------------------------------ close
    def close(self) -> None:
        """Stop the keepalive and send ``STOP``: every follower returns
        from `follow`.  Close the front end first.  Idempotent."""
        self._stop.set()
        self._keepalive.join()
        with self._lock:
            if not self._closed:
                self._send(STOP)
                self._closed = True

    def __enter__(self) -> "MeshLeader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def follow(engine) -> MeshStats:
    """Every rank but 0: make the leader's calls on ``engine`` in its
    order until ``STOP``; returns this rank's `MeshStats`."""
    mesh = engine.mesh
    if mesh.rank == 0:
        raise ValueError("rank 0 leads (MeshLeader); it does not follow")
    stats = MeshStats()
    buf = torch.zeros(message_size(engine), dtype=torch.int32)
    while True:
        msg = mesh.broadcast(buf, axes=mesh.axis_names)
        t0 = time.perf_counter()
        op = int(msg[0])
        stats.messages[OPS[op]] += 1
        if op == STOP:
            return stats
        if op != NOOP:
            _run(engine, msg)
            stats.dispatches.append((OPS[op], time.perf_counter() - t0))
