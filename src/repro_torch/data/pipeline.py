"""Deterministic synthetic token pipeline (the reference's
``data/pipeline.py``, the same numpy code: every batch is bit-identical).

The stream is a pure function of ``(seed, step)`` — the data cursor is the
step counter, so a restart from step N sees the batch the lost run would
have seen.  Tokens follow an order-1 Markov chain with a few heavy
transitions, so a small model visibly learns.  A background thread keeps
``depth`` batches ahead, as a host-side input pipeline does.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import PATCH_EMBED_DIM


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg, self.batch, self.seq_len = cfg, batch, seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        v = cfg.vocab_size
        # sparse-ish Markov chain: every token has 4 likely successors
        self.succ = rng.integers(0, v, (v, 4))

    def _tokens(self, rng, shape):
        v = self.cfg.vocab_size
        flat = np.empty(int(np.prod(shape)), np.int32)
        flat[0] = rng.integers(0, v)
        jumps = rng.random(len(flat)) < 0.1
        choices = rng.integers(0, 4, len(flat))
        randoms = rng.integers(0, v, len(flat))
        for i in range(1, len(flat)):
            flat[i] = (randoms[i] if jumps[i]
                       else self.succ[flat[i - 1], choices[i]])
        return flat.reshape(shape)

    def batch_at(self, step: int) -> dict:
        """Batch for one optimizer step (a pure function of step): int32
        ``tokens`` and ``labels`` (B, L) (audio (B, K, L)), a patched
        config's float32 ``patch_embeds`` (B, P, `PATCH_EMBED_DIM`), whose
        positions count in ``seq_len``."""
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        L = self.seq_len
        if cfg.num_codebooks:
            toks = self._tokens(rng, (self.batch, cfg.num_codebooks, L + 1))
            batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        else:
            Lt = L - cfg.num_patches
            toks = self._tokens(rng, (self.batch, Lt + 1))
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.num_patches:
            batch["patch_embeds"] = rng.normal(
                0, 0.3, (self.batch, cfg.num_patches, PATCH_EMBED_DIM)
            ).astype(np.float32)
        return batch


class Prefetcher:
    """Background thread producing ``batch_at(step)`` ahead of the loop."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth=2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._next
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
