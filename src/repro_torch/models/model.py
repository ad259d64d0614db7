"""Decoder-only LM of the substrate (the reference's ``models/model.py``),
for configurations whose layers are all ``dense`` GQA blocks: llama3.2-3b,
qwen1.5-110b, command-r-35b, nemotron-4-340b, phi-3-vision-4.2b (patches
off) and musicgen-medium.

The reference scans one stacked parameter tree over its layers; here each
layer's weights are one `Block` module and the stack is a ``ModuleList``
(``remat``, ``scan_layers`` and ``fsdp_per_layer_gather`` tune that scan
and have no counterpart).  Audio sums its codebooks' embeddings and emits
``num_codebooks`` heads of logits.  MoE, MLA, the mamba blocks and patch
embeddings raise `NotImplementedError` (`check_supported`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, common, mlp
from repro_torch.models.config import ModelConfig

SSD_UNPORTED = ("mamba / SSD blocks (models/ssm.py: mamba2, zamba2's hybrid "
                "stack) are not ported yet: they come with a later slice of "
                "the LM substrate (ROADMAP queue 1, item 15)")
PATCHES_UNPORTED = ("patch embeddings (phi-3-vision's num_patches) are not "
                    "ported yet: set num_patches=0, as both launchers do "
                    "(ROADMAP queue 1, item 15)")


# ------------------------------------------------------------------ pattern
def stacks_of(cfg: ModelConfig) -> list[tuple[list[str], int]]:
    if cfg.family == "ssm":
        return [(["mamba"], cfg.num_layers)]
    if cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        return [(["mamba"] * (e - 1) + ["mamba_attn"], cfg.num_layers // e)]
    if cfg.family == "moe":
        out = []
        if cfg.first_dense_layers:
            out.append((["dense"], cfg.first_dense_layers))
        rest = cfg.num_layers - cfg.first_dense_layers
        if cfg.moe_every > 1:
            pat = ["dense"] * (cfg.moe_every - 1) + ["moe"]
            out.append((pat, rest // cfg.moe_every))
        else:
            out.append((["moe"], rest))
        return out
    return [(["dense"], cfg.num_layers)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` unless every layer of ``cfg`` is a
    ``dense`` GQA block without patch embeddings — before anything is
    allocated."""
    kinds = {kind for pattern, _ in stacks_of(cfg) for kind in pattern}
    if kinds & {"mamba", "mamba_attn"}:
        raise NotImplementedError(SSD_UNPORTED)
    if "moe" in kinds:
        raise NotImplementedError(mlp.MOE_UNPORTED)
    if cfg.attention == "mla":
        raise NotImplementedError(attention.MLA_UNPORTED)
    if cfg.num_patches:
        raise NotImplementedError(PATCHES_UNPORTED)


# ------------------------------------------------------------------ modules
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One dense layer's weights: ``norm1``, ``attn`` (GQA), ``norm2``,
    ``mlp``."""

    def __init__(self, norm1, attn: nn.ParameterDict, norm2,
                 mlp_p: nn.ParameterDict):
        super().__init__()
        self.norm1 = _param(norm1)
        self.attn = attn
        self.norm2 = _param(norm2)
        self.mlp = mlp_p


class LM(nn.Module):
    """The model's weights: ``embedding`` (V, d) (audio: (K, V, d)),
    ``unembed`` (d, V) (audio: (d, K·V)), ``final_norm`` and one `Block`
    per layer in ``layers``."""

    def __init__(self, embedding, unembed, final_norm, layers: list[Block]):
        super().__init__()
        self.embedding = _param(embedding)
        self.unembed = _param(unembed)
        self.final_norm = _param(final_norm)
        self.layers = nn.ModuleList(layers)


# --------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn on the device in float32 one tensor at a time and cast to the
    config's dtype (a full-width model never has a float32 copy)."""
    check_supported(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = common.dtype_of(cfg.dtype)
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.num_codebooks:
        embedding = torch.stack([common.embed_init(gen, v, d, dt)
                                 for _ in range(cfg.num_codebooks)])
        unembed = common.dense_init(gen, d, (cfg.num_codebooks * v,), dt)
    else:
        embedding = common.embed_init(gen, v, d, dt)
        unembed = common.dense_init(gen, d, (v,), dt)

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    layers = [Block(ones(), attention.init_gqa(gen, cfg), ones(),
                    mlp.init_mlp(gen, cfg)) for _ in range(cfg.num_layers)]
    return LM(embedding, unembed, ones(), layers)


# ------------------------------------------------------------------- embed
def embed_tokens(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """(B, L) tokens (audio: (B, K, L), codebook embeddings summed) →
    (B, L, D)."""
    if cfg.num_codebooks:
        return sum(params.embedding[k][tokens[:, k]]
                   for k in range(cfg.num_codebooks))
    return params.embedding[tokens]


def embed_inputs(params: LM, cfg: ModelConfig, batch: dict):
    """batch → (h (B, L, D), positions (B, L))."""
    if "patch_embeds" in batch:
        raise NotImplementedError(PATCHES_UNPORTED)
    h = embed_tokens(params, cfg, batch["tokens"])
    b, L = h.shape[:2]
    positions = torch.arange(L, device=h.device).expand(b, L)
    return h, positions


def _logits(params: LM, cfg: ModelConfig, h):
    """Final norm and unembedding, in the working dtype."""
    h = common.rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = h @ params.unembed
    if cfg.num_codebooks:
        b, L, _ = logits.shape
        logits = logits.reshape(b, L, cfg.num_codebooks, cfg.vocab_size)
    return logits


# ------------------------------------------------------------------ blocks
def _apply_block(p: Block, h, positions, cfg: ModelConfig):
    """One dense block; returns (h, (k, v)) for the prefill cache."""
    a_out, kv = attention.gqa_forward(
        p.attn, common.rms_norm(h, p.norm1, cfg.norm_eps), positions, cfg)
    h = h + a_out
    x2 = common.rms_norm(h, p.norm2, cfg.norm_eps)
    return h + mlp.mlp_forward(p.mlp, x2, cfg), kv


# ----------------------------------------------------------------- forward
def forward(params: LM, cfg: ModelConfig, batch: dict, *,
            collect_cache: bool = False):
    """Prefill forward.  Returns (logits (B, L, V[, K]) in the working
    dtype, aux loss (0 for dense blocks), caches): with ``collect_cache``
    one (k, v) pair per layer, each (B, L, KVH, hd); else None."""
    check_supported(cfg)
    h, positions = embed_inputs(params, cfg, batch)
    caches = []
    for layer in params.layers:
        h, kv = _apply_block(layer, h, positions, cfg)
        if collect_cache:
            caches.append(kv)
    return (_logits(params, cfg, h), torch.zeros((), device=h.device),
            caches if collect_cache else None)
