"""Batched LM serving: prefill once, decode many, static-shape caches (the
reference's ``serve/engine.py``, dense and MoE blocks, GQA and MLA).

``caches_from_prefill`` pads the pairs that
``model.forward(collect_cache=True)`` emits (prompt length) to the decode
layout of ``max_len``: ``{"k", "v"}`` dicts for GQA, the latent ``{"c",
"k_rope"}`` for MLA — one prefill pass replaces prompt_len decode steps.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.models import decode as dec
from repro_torch.models import model
from repro_torch.models.config import ModelConfig


def _pad_seq(x: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, L, ...) → (B, max_len, ...), zeros after L."""
    pad = max_len - x.shape[1]
    return (F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad > 0
            else x.contiguous())


def caches_from_prefill(cfg: ModelConfig, prefill_caches, max_len: int):
    """Prefill cache (a pair per layer, length L) → decode cache (dicts,
    max_len)."""
    names = ("c", "k_rope") if cfg.attention == "mla" else ("k", "v")
    return [{name: _pad_seq(t, max_len) for name, t in zip(names, pair)}
            for pair in prefill_caches]


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int):
    """Returns (last-position logits, decode-ready caches, prompt_len)."""
    logits, _, caches = model.forward(params, cfg, batch, collect_cache=True)
    prompt_len = logits.shape[1]
    return logits[:, -1:], caches_from_prefill(cfg, caches, max_len), \
        prompt_len


def _sample(logits: torch.Tensor, temperature: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Greedy (first index on ties, as ``jnp.argmax``) or a Gumbel-max draw
    at ``temperature`` (the method of ``jax.random.categorical``, not its
    draws)."""
    if temperature <= 0:
        return torch.argmax(logits, -1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() / temperature - torch.log(-torch.log(u)),
                        -1)


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, num_new: int,
             *, generator: torch.Generator | None = None,
             temperature: float = 0.0, max_len: int = 0,
             stats: dict | None = None) -> torch.Tensor:
    """Greedy / temperature sampling for a batch of equal-length prompts.

    prompt: (B, Lp) (audio: (B, K, Lp)).  Returns (B, num_new) tokens
    (audio: (B, K, num_new)).  As the reference, the loop makes ``num_new``
    decode steps, the last one's logits unused.  Sampling draws from
    ``generator`` (on the prompt's device), which cannot give the
    reference's ``jax.random`` draws: only greedy tokens (temperature ≤ 0)
    compare across the packages.  ``stats``, when given, receives
    ``prefill_s`` and ``decode_s`` (host clock, the device synchronised)
    and ``finite`` (every logit of the run finite)."""
    dev = prompt.device
    Lp = prompt.shape[-1]
    max_len = max_len or Lp + num_new
    batch = {"tokens": prompt, "labels": prompt}
    device_lib.synchronize(dev)
    t0 = time.perf_counter()
    logits, caches, _ = prefill(params, cfg, batch, max_len)
    finite = torch.isfinite(logits).all()
    device_lib.synchronize(dev)
    t1 = time.perf_counter()
    outs = []
    for i in range(num_new):
        tok = _sample(logits[:, -1], temperature, generator)  # (B,) / (B, K)
        tok = tok[..., None]                     # (B, 1) / (B, K, 1)
        outs.append(tok)
        logits, caches = dec.decode_step(params, cfg, caches, tok, Lp + i)
        finite &= torch.isfinite(logits).all()
    device_lib.synchronize(dev)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     finite=bool(finite))
    return torch.cat(outs, -1)
