"""Decoder-only LM of the substrate (the reference's ``models/model.py``),
for every configuration of the registry: ``dense`` and ``moe`` blocks with
GQA or MLA attention (llama3.2-3b, qwen1.5-110b, command-r-35b,
nemotron-4-340b, phi-3-vision-4.2b with its patch embeddings,
musicgen-medium, deepseek-v3-671b, llama4-maverick-400b-a17b) and
``mamba`` / ``mamba_attn`` blocks of the SSD mixer (mamba2-1.3b;
zamba2-2.7b's hybrid stack).

The reference scans one stacked parameter tree per stack of its layers;
here each layer's weights are one module (`Block` for an attention block,
`MambaBlock` for a mamba one) and the layers are one ``ModuleList`` in the
reference's order: stack by stack (`stacks_of`), group by group, pattern
position within a group (deepseek-v3: its dense layers, then MoE; llama4:
dense and MoE alternating; zamba2: five ``mamba`` layers, then a
``mamba_attn``).  ``scan_layers`` and ``fsdp_per_layer_gather`` tune that
scan and have no counterpart; ``remat`` checkpoints each layer of a
training forward (`loss_fn`), as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does each layer group.

A ``mamba_attn`` layer applies, after its mixer, the *shared* transformer
block (zamba2's weight-tied attention + MLP): one dense `Block` held once
by the `LM` as ``shared_attn``, as the reference holds it at the top of
its tree, and handed to every such layer; each invocation keeps a KV
cache of its own.  Audio sums its codebooks' embeddings and emits
``num_codebooks`` heads of logits.  A VLM config (``num_patches``) holds
a ``patch_proj`` (`PATCH_EMBED_DIM`, d): a batch that carries
``patch_embeds`` (B, num_patches, `PATCH_EMBED_DIM`), the stub of a CLIP
front end, gets their projection prepended to its token embeddings, and
positions run over both; a batch without them embeds its tokens alone,
as the reference's ``"patch_embeds" in batch`` gate does.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding_rules as rules
from repro_torch.models import attention, common, mlp, ssm
from repro_torch.models.config import ModelConfig

MAMBA_KINDS = ("mamba", "mamba_attn")
PATCH_EMBED_DIM = 1024          # the CLIP-style stub's feature width


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


class MambaBlock(nn.Module):
    """One ``mamba`` or ``mamba_attn`` layer's weights: ``norm1`` and the
    mixer's ``mamba`` (`ssm.init_mamba`'s names), nothing else — a
    ``mamba_attn`` layer's attention is the `LM`'s ``shared_attn``."""

    def __init__(self, kind: str, norm1, mamba: nn.ParameterDict):
        super().__init__()
        self.kind = kind
        self.norm1 = _param(norm1)
        self.mamba = mamba


class LM(nn.Module):
    """The model's weights: ``embedding`` (V, d) (audio: (K, V, d)),
    ``unembed`` (d, V) (audio: (d, K·V)), ``final_norm``, one `Block` or
    `MambaBlock` per layer in ``layers``, for a hybrid config the one
    ``shared_attn`` dense `Block` its ``mamba_attn`` layers apply and for
    a VLM config ``patch_proj`` (`PATCH_EMBED_DIM`, d) (each else
    None)."""

    def __init__(self, embedding, unembed, final_norm,
                 layers: list[nn.Module], shared_attn: Block | None = None,
                 patch_proj: torch.Tensor | None = None):
        super().__init__()
        self.embedding = _param(embedding)
        self.unembed = _param(unembed)
        self.final_norm = _param(final_norm)
        self.layers = nn.ModuleList(layers)
        self.shared_attn = shared_attn
        self.patch_proj = None if patch_proj is None else _param(patch_proj)


# --------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                keep=None) -> LM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn on the device in float32 one tensor (one expert) at a time and
    cast to the config's dtype (a full-width model never has a float32
    copy); MoE routers and the mixers' ``a_log``, ``d_skip`` and
    ``dt_bias`` stay float32.  Drawn in the reference's order: embedding,
    unembedding, the patch projection, the shared block, then the
    layers.  ``keep(name, tensor)``, when given, replaces each leaf by
    what it returns (a rank's shard, `distributed.fsdp.Layout.local`) as
    soon as the leaf, or the layer that holds it, is drawn: the draws are
    the one-device draws, and a rank never holds more than one layer at
    full size beyond its shards."""
    dev = torch.device(device)
    gen = (common.ShapeOnly() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = common.dtype_of(cfg.dtype)
    d, v = cfg.d_model, cfg.vocab_size
    take = keep or (lambda name, t: t)

    def kept(module: nn.Module, prefix: str) -> nn.Module:
        with torch.no_grad():
            for name, p in module.named_parameters(prefix=prefix):
                p.data = take(name, p.data)
        return module

    if cfg.num_codebooks:
        embedding = take("embedding", torch.stack([
            common.embed_init(gen, v, d, dt)
            for _ in range(cfg.num_codebooks)]))
        unembed = take("unembed", common.dense_init(
            gen, d, (cfg.num_codebooks * v,), dt))
    else:
        embedding = take("embedding", common.embed_init(gen, v, d, dt))
        unembed = take("unembed", common.dense_init(gen, d, (v,), dt))
    patch_proj = (take("patch_proj", common.dense_init(
        gen, PATCH_EMBED_DIM, (d,), dt)) if cfg.num_patches else None)

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    shared = (kept(Block("dense", ones(), attention.init_gqa(gen, cfg),
                         ones(), mlp.init_mlp(gen, cfg)), "shared_attn")
              if cfg.family == "hybrid" else None)
    attn_init = (attention.init_mla if cfg.attention == "mla"
                 else attention.init_gqa)

    def layer(i, kind):
        if kind in MAMBA_KINDS:
            block = MambaBlock(kind, ones(), ssm.init_mamba(gen, cfg))
        else:
            block = Block(kind, ones(), attn_init(gen, cfg), ones(),
                          mlp.init_moe(gen, cfg) if kind == "moe"
                          else mlp.init_mlp(gen, cfg))
        return kept(block, f"layers.{i}")

    layers = [layer(i, kind) for i, kind in enumerate(layer_kinds(cfg))]
    return LM(embedding, unembed, take("final_norm", ones()), layers, shared,
              patch_proj)


def param_shapes(cfg: ModelConfig) -> LM:
    """The parameter skeleton (shapes and dtypes) on the meta device:
    nothing is allocated or drawn."""
    return init_params(cfg, device="meta")


def layout_on(mesh, cfg: ModelConfig) -> fsdp.Layout:
    """Where ``cfg``'s parameters live on a training ``mesh``
    (`distributed.fsdp.Layout`): each leaf's spec is the reference's for
    its path (`distributed.sharding_rules.param_shardings`)."""
    shapes = {k: tuple(t.shape) for k, t in
              param_shapes(cfg).named_parameters()}
    return fsdp.Layout(mesh, rules.param_shardings(
        mesh, shapes, stacks_of(cfg)), shapes)


def trainable(params: LM) -> LM:
    """Turn gradients on for every weight (serving keeps them off)."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


# ------------------------------------------------------------------- embed
def embed_tokens(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """(B, L) tokens (audio: (B, K, L), codebook embeddings summed) →
    (B, L, D)."""
    if cfg.num_codebooks:
        return sum(params.embedding[k][tokens[:, k]]
                   for k in range(cfg.num_codebooks))
    return params.embedding[tokens]


def embed_inputs(params: LM, cfg: ModelConfig, batch: dict):
    """batch → (h (B, L, D), positions (B, L)).  With ``patch_embeds``
    (B, P, `PATCH_EMBED_DIM`) and a patched config, h is their projection
    through ``patch_proj``, cast to the tokens' dtype, then the tokens'
    embeddings: L = P + tokens.  The product is taken in the two
    operands' promoted dtype, as jnp's ``@`` takes it (float32 patches
    with bf16 weights: float32), before the cast."""
    h = embed_tokens(params, cfg, batch["tokens"])
    if cfg.num_patches and "patch_embeds" in batch:
        pe, w = batch["patch_embeds"], params.patch_proj
        dt = torch.promote_types(pe.dtype, w.dtype)
        h = torch.cat([(pe.to(dt) @ w.to(dt)).to(h.dtype), h], dim=1)
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
def ffn_forward(p: Block, x, cfg: ModelConfig, mesh=None):
    """The block's MLP or MoE: (out, aux loss; None for an MLP).  On a
    training ``mesh`` the MoE takes this rank's rows
    (`mlp.moe_forward_sharded`)."""
    if p.kind == "moe":
        if mesh is not None:
            return mlp.moe_forward_sharded(p.moe, x, cfg, mesh)
        return mlp.moe_forward(p.moe, x, cfg)
    return mlp.mlp_forward(p.mlp, x, cfg), None


def _gathered(p: nn.Module, layout, cfg: ModelConfig, length: int,
              serve=None):
    """``p``'s leaves at full size on a training or serving mesh
    (`fsdp.gather_module`); a MoE block on the a2a route keeps E/S whole
    experts (serving takes that route only where its rows split,
    `mlp.moe_forward_serve`)."""
    mesh = layout.mesh
    a2a = p.kind == "moe" and mlp.a2a_route(cfg, mesh, length) and (
        serve is None or bool(serve.row_axes))
    el = cfg.num_experts // mesh.shape["model"] if a2a else 0
    return fsdp.gather_module(p, layout, el)


def _apply_block(p: nn.Module, h, positions, cfg: ModelConfig,
                 shared: Block | None = None, layout=None, serve=None):
    """One block; returns (h, aux or None, cache): (k, v) for GQA, (c,
    k_rope) for MLA, (state, conv tail) for ``mamba`` and ((state, conv
    tail), (k, v)) for ``mamba_attn``, whose attention and MLP are those of
    ``shared``.  With the ``layout`` of a training mesh (`fsdp.Layout`)
    the block's shards are gathered here, inside what remat recomputes, so
    the backward gathers them again and one layer at a time is held at
    full size (the hybrid's ``shared`` at each of its uses).  With the
    ``serve`` `decode.CacheLayout` of a serving mesh the MoE takes
    serving's dispatch (`mlp.moe_forward_serve`)."""
    mesh = None
    if layout is not None:
        p, mesh = _gathered(p, layout, cfg, h.shape[1], serve), layout.mesh
    if p.kind in MAMBA_KINDS:
        out, cache = ssm.mamba_forward(
            p.mamba, common.rms_norm(h, p.norm1, cfg.norm_eps), cfg)
        h = h + out
        if p.kind == "mamba_attn":
            h, _, kv = _apply_block(shared, h, positions, cfg,
                                    layout=layout, serve=serve)
            cache = (cache, kv)
        return h, None, cache
    attn_fwd = (attention.mla_forward if cfg.attention == "mla"
                else attention.gqa_forward)
    a_out, kv = attn_fwd(p.attn, common.rms_norm(h, p.norm1, cfg.norm_eps),
                         positions, cfg)
    h = h + a_out
    x = common.rms_norm(h, p.norm2, cfg.norm_eps)
    if serve is not None and p.kind == "moe":
        out, aux = mlp.moe_forward_serve(p.moe, x, cfg, serve.mesh,
                                         serve.rows_view())
    else:
        out, aux = ffn_forward(p, x, cfg, mesh)
    return h + out, aux, kv


# ----------------------------------------------------------------- forward
def _top(params: LM, layout, *names: str):
    """``params`` itself, or on a training mesh a view of the named
    top-level leaves gathered to full size (None where absent)."""
    if layout is None:
        return params
    return fsdp.View(None, {
        n: None if getattr(params, n) is None
        else fsdp.gather(getattr(params, n), layout) for n in names})


def forward(params: LM, cfg: ModelConfig, batch: dict, *,
            collect_cache: bool = False, remat: bool = False, mesh=None,
            serve=None):
    """Training or prefill forward.  Returns (logits (B, L, V[, K]) in the
    working dtype, the MoE layers' aux losses summed in float32 (0 without
    MoE), caches): with ``collect_cache`` one entry per layer, (k, v) each
    (B, L, KVH, hd) for GQA, (c (B, L, kr), k_rope (B, L, rd)) for MLA,
    (state (B, H, S, P) float32, conv tail (B, w-1, d_inner + 2S)) for
    ``mamba`` and ((state, tail), (k, v)) for ``mamba_attn``; else None.
    With ``remat`` and gradients on, each layer runs under a non-reentrant
    activation checkpoint: its backward recomputes it from its input.

    On a training ``mesh`` (`distributed.comm.Mesh`) ``params`` holds this
    rank's shards (`distributed.fsdp.Layout.shard`) and ``batch`` this
    rank's rows: each leaf is gathered where it is used (a layer's inside
    its checkpoint; the embedding first, the final norm and unembedding
    last) and the MoE layers take the sharded dispatch; the aux losses
    are then the global ones.  A mesh without a group (one process
    alone, `distributed.fsdp.one_rank`) holds every leaf whole: nothing
    is gathered.

    A prefill on a serving mesh passes its `decode.CacheLayout` as
    ``serve`` (``mesh`` is then its mesh) and ``batch`` holds this rank's
    rows (`decode.CacheLayout.rows`), the same on every ``model`` rank:
    the weights are gathered as in training, the MoE takes serving's
    dispatch, and each layer's cache is cut at once to this rank's slice
    of the decode layout (`decode.CacheLayout.local`, padded to its
    length), so ``caches`` holds the decode caches
    (`decode.ShardedCaches`)."""
    if serve is not None:
        mesh, collect_cache = serve.mesh, True
    layout = (None if mesh is None or mesh.backend is None
              else fsdp.layout_of(params, mesh))
    h, positions = embed_inputs(_top(params, layout, "embedding",
                                     "patch_proj"), cfg, batch)
    caches = []
    total_aux = torch.zeros((), device=h.device)
    remat = remat and torch.is_grad_enabled()
    for i, layer in enumerate(params.layers):
        if remat:
            h, aux, kv = checkpoint(_apply_block, layer, h, positions, cfg,
                                    params.shared_attn, layout,
                                    use_reentrant=False)
        else:
            h, aux, kv = _apply_block(layer, h, positions, cfg,
                                      params.shared_attn, layout, serve)
        if aux is not None:
            total_aux = total_aux + aux
        if serve is not None:
            kv = _local_cache(serve, cfg, i, layer.kind, kv)
        if collect_cache:
            caches.append(kv)
    if serve is not None:
        from repro_torch.models.decode import ShardedCaches
        caches = ShardedCaches(caches, serve)
    return (_logits(_top(params, layout, "final_norm", "unembed"), cfg, h),
            total_aux, caches if collect_cache else None)


def _local_cache(serve, cfg: ModelConfig, i: int, kind: str, kv):
    """Layer ``i``'s prefill cache as this rank's decode-layout dicts
    (`forward`'s ``serve``)."""
    names = ("c", "k_rope") if cfg.attention == "mla" else ("k", "v")

    def cut(keys, parts):
        return {key: serve.local(f"layers.{i}.{key}", t)
                for key, t in zip(keys, parts)}

    if kind == "mamba":
        return cut(("state", "conv"), kv)
    if kind == "mamba_attn":
        return cut(("state", "conv"), kv[0]), cut(("k", "v"), kv[1])
    return cut(names, kv)


def loss_fn(params: LM, cfg: ModelConfig, batch: dict,
            aux_coef: float = 0.01, mesh=None):
    """Training loss, the reference's: cross-entropy with z-loss of the
    float32 logits against ``labels`` (audio (B, K, L), swapped to (B, L,
    K); with ``patch_embeds`` the patch positions take label -1, which the
    loss ignores), plus ``aux_coef`` times the MoE aux loss.  Returns
    (loss, {"ce", "aux"}); the forward checkpoints its layers under
    ``cfg.remat``.

    On a training ``mesh`` (see `forward`) the loss is this rank's share
    of the global loss, so that the shares sum to it: its rows' token
    losses summed, over the global count of labels that are not ignored
    (one all-reduce of the ranks' counts), plus ``aux_coef`` times the
    global aux over the number of ranks."""
    logits, aux, _ = forward(params, cfg, batch, remat=cfg.remat, mesh=mesh)
    labels = batch["labels"]
    if cfg.num_codebooks:
        labels = labels.transpose(1, 2)
    if cfg.num_patches and "patch_embeds" in batch:
        pad = labels.new_full((*labels.shape[:-1], cfg.num_patches), -1)
        labels = torch.cat([pad, labels], dim=-1)
    nll, count = common.token_nll_sum(logits, labels)
    ranks = 1
    if mesh is not None:
        count, ranks = mesh.psum(count, mesh.axis_names), fsdp.mesh_size(mesh)
    loss = nll / count.clamp_min(1)
    aux = aux / ranks
    return loss + aux_coef * aux, {"ce": loss, "aux": aux}
