"""Meta-tensor stand-ins for every (arch × shape) cell, and their specs on a
mesh (the port's counterpart of ``repro.launch.specs``).

The reference's ``jax.ShapeDtypeStruct`` trees become tensors on the
meta device: shapes and dtypes, nothing allocated.  ``*_specs`` return
what the dry-run's step functions take (`launch.dryrun`), in the port's
layouts: a batch dict, the per-layer decode caches of
`models.decode.init_caches`, the parameter skeleton of
`models.model.param_shapes` and `optim.adamw.AdamWState` moments keyed by
parameter name.  ``*_shardings`` return the port's spec tuples
(`distributed.sharding_rules`: one entry a dimension, None, an axis or a
tuple of axes), the reference's ``PartitionSpec``s through the same
`sanitize`: the batch's rows over the data axes, the caches by the
reference's ``_CACHE_RULES`` (`sharding_rules.cache_spec`), the moments
as their parameters.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding_rules as rules
from repro_torch.models import common, decode, model
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                with_labels: bool = True) -> dict:
    """The global batch of ``shape``: tokens (B, L) (audio (B, K, L); with
    patches L less the patches) and their labels, and the bf16 patch
    embeddings of a patched config."""
    b, L = shape.global_batch, shape.seq_len
    if cfg.num_codebooks:
        tok = (b, cfg.num_codebooks, L)
    else:
        tok = (b, L - cfg.num_patches)
    out = {"tokens": _meta(tok, torch.int32)}
    if with_labels:
        out["labels"] = _meta(tok, torch.int32)
    if cfg.num_patches:
        out["patch_embeds"] = _meta((b, cfg.num_patches,
                                     model.PATCH_EMBED_DIM), torch.bfloat16)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(caches, tokens, cur_len) of a decode step of ``shape``: the
    per-layer caches of ``shape.seq_len`` positions (with a ``mesh`` this
    rank's `decode.ShardedCaches`), the (B, 1) tokens (audio (B, K, 1))
    and ``cur_len = seq_len - 1``, the step that sees every key."""
    b, L = shape.global_batch, shape.seq_len
    caches = decode.init_caches(cfg, b, L, "meta", mesh=mesh)
    tok = (b, cfg.num_codebooks, 1) if cfg.num_codebooks else (b, 1)
    return caches, _meta(tok, torch.int32), L - 1


def param_specs(cfg: ModelConfig) -> model.LM:
    return model.param_shapes(cfg)


def opt_specs(cfg: ModelConfig, params) -> adamw.AdamWState:
    """Zero AdamW moments of the config's optimizer-state dtype, one per
    parameter of ``params`` (meta, or a rank's shards), on its device."""
    return adamw.init(params, common.dtype_of(cfg.optimizer_state_dtype))


# ------------------------------------------------------------- shardings
def batch_shardings(mesh, batch_shapes: dict) -> dict:
    """Each batch leaf's spec: rows over the data axes, sanitized."""
    return {k: rules.batch_spec(mesh, tuple(t.shape))
            for k, t in batch_shapes.items()}


def cache_shardings(mesh, cache_shapes: list) -> list:
    """The spec of every leaf of a per-layer cache list (whole, not a
    rank's), in the list's structure: the reference's ``_CACHE_RULES``
    by leaf name (`sharding_rules.cache_spec`)."""
    def one(part: dict) -> dict:
        return {k: rules.cache_spec(mesh, k, tuple(t.shape))
                for k, t in part.items()}

    return [tuple(one(p) for p in c) if isinstance(c, tuple) else one(c)
            for c in cache_shapes]


def param_shardings(mesh, cfg: ModelConfig, params=None) -> dict:
    """Every parameter's spec by name (`sharding_rules.param_shardings`
    in the reference's stacked layout)."""
    params = param_specs(cfg) if params is None else params
    return rules.param_shardings(
        mesh, {k: tuple(t.shape) for k, t in params.named_parameters()},
        model.stacks_of(cfg))


def opt_shardings(mesh, opt_shapes: adamw.AdamWState,
                  param_sh: dict) -> adamw.AdamWState:
    """Adam moments shard exactly like their parameters (ZeRO); the step
    count is replicated."""
    return adamw.AdamWState(step=(), m=dict(param_sh), v=dict(param_sh))
