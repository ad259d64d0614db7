"""Serving launcher: batched prefill + decode (the reference's
``launch/serve.py``).

    python -m repro_torch.launch.serve --arch llama3.2-3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v3-671b --smoke --device cpu
    python -m repro_torch.launch.serve --arch llama3.2-3b      # one GPU

Weights are random, from a seeded generator on the device (no checkpoint is
read); prompts come from ``numpy.random.default_rng(0)``.  GQA attention
runs the hand-written CUDA kernel on a GPU and its plain version with
``--device cpu``; MLA and MoE run plain PyTorch on either.  An arch with
SSD blocks raises `NotImplementedError` before anything is allocated.
`serve_config` serves a `ModelConfig` of the caller's (a depth-cut one,
say) through the same code as `run`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.serve import engine

PARAM_SEED, PROMPT_SEED, SAMPLE_SEED = 0, 0, 3


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Serve the arch ``args`` name (its smoke config with ``--smoke``)."""
    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    return serve_config(dataclasses.replace(cfg, num_patches=0), args)


@torch.inference_mode()
def serve_config(cfg: ModelConfig, args: argparse.Namespace) -> dict:
    """Initialise ``cfg``'s model, serve one batch of requests of ``args``
    (batch, prompt length, new tokens, temperature, device), print the
    ``[launch.serve]`` line; returns the tokens and the run's numbers (the
    model's bytes among them; the model itself is freed on return)."""
    model.check_supported(cfg)
    dev = device_lib.resolve(args.device)
    params = model.init_params(cfg, seed=PARAM_SEED, device=dev)
    rng = np.random.default_rng(PROMPT_SEED)
    shape = ((args.batch, cfg.num_codebooks, args.prompt_len)
             if cfg.num_codebooks else (args.batch, args.prompt_len))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SAMPLE_SEED)
    stats = {}
    t0 = time.perf_counter()
    tokens = engine.generate(params, cfg, prompt, args.new_tokens,
                             generator=gen, temperature=args.temperature,
                             stats=stats)
    dt = time.perf_counter() - t0
    decode_ms = 1e3 * stats["decode_s"] / max(args.new_tokens, 1)
    print(f"[launch.serve] {cfg.name}: {args.batch} requests × "
          f"{args.new_tokens} tokens in {dt:.2f}s (prefill of "
          f"{args.prompt_len} tokens {stats['prefill_s']:.3f}s, decode "
          f"{decode_ms:.2f} ms/step) on {dev}")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in params.parameters())
    return dict(cfg=cfg, prompt=prompt, tokens=tokens, seconds=dt,
                decode_ms_per_step=decode_ms, param_bytes=param_bytes,
                **stats)


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
