"""Decoder-only LM of the substrate (the reference's ``models/model.py``),
for configurations built of ``dense`` and ``moe`` blocks with GQA or MLA
attention: llama3.2-3b, qwen1.5-110b, command-r-35b, nemotron-4-340b,
phi-3-vision-4.2b (patches off), musicgen-medium, deepseek-v3-671b and
llama4-maverick-400b-a17b.

The reference scans one stacked parameter tree per stack of its layers;
here each layer's weights are one `Block` module and the layers are one
``ModuleList`` in the reference's order: stack by stack (`stacks_of`),
group by group, pattern position within a group (deepseek-v3: its dense
layers, then MoE; llama4: dense and MoE alternating).  ``remat``,
``scan_layers`` and ``fsdp_per_layer_gather`` tune that scan and have no
counterpart.  Audio sums its codebooks' embeddings and emits
``num_codebooks`` heads of logits.  The mamba blocks and patch embeddings
raise `NotImplementedError` (`check_supported`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, common, mlp
from repro_torch.models.config import ModelConfig

SSD_UNPORTED = ("mamba / SSD blocks (models/ssm.py: mamba2, zamba2's hybrid "
                "stack) are not ported yet: they come with a later slice of "
                "the LM substrate (ROADMAP §1, 'Slice I, the rest of the LM "
                "substrate')")
PATCHES_UNPORTED = ("patch embeddings (phi-3-vision's num_patches) are not "
                    "ported yet: set num_patches=0, as both launchers do; "
                    "they come with a later slice (ROADMAP §1, 'Slice I, "
                    "the rest of the LM substrate')")


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


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Each layer's block kind, in the reference's order (module
    docstring)."""
    return [kind for pattern, groups in stacks_of(cfg)
            for _ in range(groups) for kind in pattern]


def check_supported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` unless every layer of ``cfg`` is a
    ``dense`` or ``moe`` block and it has no patch embeddings — before
    anything is allocated."""
    kinds = {kind for pattern, _ in stacks_of(cfg) for kind in pattern}
    if kinds & {"mamba", "mamba_attn"}:
        raise NotImplementedError(SSD_UNPORTED)
    if cfg.num_patches:
        raise NotImplementedError(PATCHES_UNPORTED)


# ------------------------------------------------------------------ modules
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer's weights: ``norm1``, ``attn`` (GQA or MLA), ``norm2`` and
    ``ffn`` as ``mlp`` (a ``dense`` block) or ``moe`` (``kind`` "moe"), the
    reference's names."""

    def __init__(self, kind: str, norm1, attn: nn.ParameterDict, norm2,
                 ffn: nn.ParameterDict):
        super().__init__()
        self.kind = kind
        self.norm1 = _param(norm1)
        self.attn = attn
        self.norm2 = _param(norm2)
        setattr(self, "moe" if kind == "moe" else "mlp", ffn)


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
    drawn on the device in float32 one tensor (one expert) at a time and
    cast to the config's dtype (a full-width model never has a float32
    copy); MoE routers stay float32."""
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

    attn_init = (attention.init_mla if cfg.attention == "mla"
                 else attention.init_gqa)
    layers = [Block(kind, ones(), attn_init(gen, cfg), ones(),
                    mlp.init_moe(gen, cfg) if kind == "moe"
                    else mlp.init_mlp(gen, cfg))
              for kind in layer_kinds(cfg)]
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
def ffn_forward(p: Block, x, cfg: ModelConfig):
    """The block's MLP or MoE: (out, aux loss; None for an MLP)."""
    if p.kind == "moe":
        return mlp.moe_forward(p.moe, x, cfg)
    return mlp.mlp_forward(p.mlp, x, cfg), None


def _apply_block(p: Block, h, positions, cfg: ModelConfig):
    """One block; returns (h, aux or None, cache pair): (k, v) for GQA,
    (c, k_rope) for MLA."""
    attn_fwd = (attention.mla_forward if cfg.attention == "mla"
                else attention.gqa_forward)
    a_out, kv = attn_fwd(p.attn, common.rms_norm(h, p.norm1, cfg.norm_eps),
                         positions, cfg)
    h = h + a_out
    out, aux = ffn_forward(p, common.rms_norm(h, p.norm2, cfg.norm_eps), cfg)
    return h + out, aux, kv


# ----------------------------------------------------------------- forward
def forward(params: LM, cfg: ModelConfig, batch: dict, *,
            collect_cache: bool = False):
    """Prefill forward.  Returns (logits (B, L, V[, K]) in the working
    dtype, the MoE layers' aux losses summed in float32 (0 without MoE),
    caches): with ``collect_cache`` one pair per layer, (k, v) each (B, L,
    KVH, hd) for GQA, (c (B, L, kr), k_rope (B, L, rd)) for MLA; else
    None."""
    check_supported(cfg)
    h, positions = embed_inputs(params, cfg, batch)
    caches = []
    total_aux = torch.zeros((), device=h.device)
    for layer in params.layers:
        h, aux, kv = _apply_block(layer, h, positions, cfg)
        if aux is not None:
            total_aux = total_aux + aux
        if collect_cache:
            caches.append(kv)
    return (_logits(params, cfg, h), total_aux,
            caches if collect_cache else None)
