"""Single-token decode with static-shape caches (the reference's
``models/decode.py``, every block kind), on one device or a mesh.

Caches are one entry per layer (the reference stacks them over its
scanned layers): GQA ``{k, v}`` each (B, Lmax, KVH, hd) and MLA the latent
``{c (B, Lmax, kv_lora_rank), k_rope (B, Lmax, rope_head_dim)}``, in the
working dtype; ``mamba`` ``{state (B, H, S, P) float32, conv (B, w-1,
d_inner + 2S)}``, O(1) in the context length; ``mamba_attn`` the pair
(mamba cache, the shared block's own ``{k, v}``).  `decode_step` writes
each layer's new entries into its cache in place and returns the same
list.

On a mesh (``mesh=``, a `distributed.comm.Mesh`, one process a position,
or the dry-run's `distributed.comm.ShapeMesh`) the caches follow the
reference's layout (``launch/specs.cache_shardings``,
`distributed.sharding_rules.cache_spec`), which turns its GSPMD decode
into a sequence-parallel flash decode; `CacheLayout` holds it.  A batch's
rows split over the data axes (replicated over what `sanitize` drops,
long_500k's one row), every ``model`` rank holding the same rows; each
attention cache's sequence splits over ``model`` (rank r holds positions
``[r·Lc, (r+1)·Lc)``), the SSM state's heads and the conv tail's
channels too.  `decode_step` then gathers each layer's weights
(ZeRO-3, `distributed.fsdp`, as training does), looks the tokens up in
each rank's columns of the embedding and multiplies by each rank's block
of the unembedding (tensor parallel: those two tables are not gathered),
and:

* GQA: the rank that owns ``cur_len`` writes the new key and value;
  every rank runs the ``decode`` kernel over its visible local keys,
  which also returns each row's log-sum-exp, and one all-gather over
  ``model`` merges the ranks' (out, lse) in float32 into one device's
  result (`attention.merge_partials`);
* MLA: the same split and merge, in plain PyTorch;
* SSD: each rank convolves its channels, the conv output is all-gathered
  over ``model``, each rank updates its heads' state, and their outputs
  are all-gathered before the out projection;
* MoE: the dispatch the reference's dispatcher takes on the mesh
  (`mlp.moe_forward_serve`).

A leaf whose length or head count does not divide over ``model`` is held
whole by every rank and decoded as one device does.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import comm, fsdp
from repro_torch.distributed import sharding_rules as rules
from repro_torch.models import attention, common, mlp, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, MAMBA_KINDS, Block, _gathered,
                                      _logits, _top, embed_tokens,
                                      ffn_forward, layer_kinds)


def _leaf_shapes(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """Each layer's cache leaves as ``{key: (shape, dtype)}`` (a pair of
    such dicts for ``mamba_attn``; module docstring), without a
    tensor."""
    dt = common.dtype_of(cfg.dtype)
    out = []
    for kind in layer_kinds(cfg):
        if kind in MAMBA_KINDS:
            mamba = ssm.mamba_cache_shapes(cfg, batch)
            out.append(mamba if kind == "mamba" else (
                mamba, attention.gqa_cache_shapes(cfg, batch, max_len, dt)))
        elif cfg.attention == "mla":
            out.append(attention.mla_cache_shapes(cfg, batch, max_len, dt))
        else:
            out.append(attention.gqa_cache_shapes(cfg, batch, max_len, dt))
    return out


def cache_leaves(caches: list):
    """(name, dict, key) of every leaf of a cache list (or of
    `_leaf_shapes`), named ``layers.<i>.<key>`` (a ``mamba_attn`` layer's
    two dicts have distinct keys)."""
    for i, c in enumerate(caches):
        for part in (c if isinstance(c, tuple) else (c,)):
            for key in part:
                yield f"layers.{i}.{key}", part, key


class CacheLayout:
    """Where a serving batch of ``batch`` rows and its decode caches of
    ``max_len`` positions live on ``mesh`` (module docstring): ``leaves``
    the `fsdp.Layout` of every cache leaf (by `cache_leaves` name, its
    `sharding_rules.cache_spec`), ``row_axes`` the axes the rows split
    over (none when they do not divide)."""

    def __init__(self, mesh, cfg: ModelConfig, batch: int, max_len: int):
        self.mesh, self.cfg = mesh, cfg
        self.batch, self.max_len = batch, max_len
        self.row_axes = rules.entry_axes(rules.batch_spec(mesh, (batch,))[0])
        shapes = {n: d[k][0] for n, d, k in cache_leaves(
            _leaf_shapes(cfg, batch, max_len))}
        self.leaves = fsdp.Layout(mesh, {
            n: rules.cache_spec(mesh, n.rsplit(".", 1)[1], s)
            for n, s in shapes.items()}, shapes)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (B, …) tensor: block ``i`` of the
        row axes' product, the first axis major."""
        i, ways = 0, 1
        for a in self.row_axes:
            i = i * self.mesh.shape[a] + self.mesh.axis_index(a)
            ways *= self.mesh.shape[a]
        n = x.shape[0]
        return x[i * n // ways:(i + 1) * n // ways]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a (B_local, …) tensor, in global order."""
        for a in reversed(self.row_axes):
            x = self.mesh.all_gather(x.contiguous(), a)
        return x

    def rows_view(self):
        """The mesh along the row axes (`comm.AxesView`), on which each
        row is seen once; None when the rows do not split."""
        return comm.AxesView(self.mesh, self.row_axes) \
            if self.row_axes else None

    def split(self, name: str, dim: int) -> bool:
        """Whether leaf ``name``'s dimension ``dim`` splits over
        ``model``."""
        return "model" in rules.entry_axes(self.leaves.specs[name][dim])

    def local(self, name: str, rows_local: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a leaf whose rows are already its own
        (every dimension but the first cut as the layout says; a sequence
        shorter than ``max_len`` padded with zeros first)."""
        sl = self.leaves.slices(name)
        full = self.leaves.shapes[name]
        out = rows_local
        for dim in range(1, len(full)):
            s = sl[dim]
            if out.shape[dim] < full[dim]:        # a prompt: pad, then cut
                keep = out.narrow(dim, min(s.start, out.shape[dim]),
                                  max(0, min(s.stop, out.shape[dim])
                                      - s.start))
                pad = list(out.shape)
                pad[dim] = (s.stop - s.start) - keep.shape[dim]
                out = torch.cat([keep, keep.new_zeros(pad)], dim)
            elif s.stop - s.start != full[dim]:
                out = out.narrow(dim, s.start, s.stop - s.start)
        return out.contiguous()

    def seq_base(self, name: str) -> int:
        """The first position a rank holds of a cache leaf's sequence."""
        return self.leaves.slices(name)[1].start


class ShardedCaches(list):
    """A rank's decode caches on a mesh: the per-layer list of its local
    leaves, and their `CacheLayout` (``layout``)."""

    def __init__(self, caches, layout: CacheLayout):
        super().__init__(caches)
        self.layout = layout


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                mesh=None) -> list:
    """Zero caches, one per layer (module docstring): each ``mamba_attn``
    layer gets a KV cache of its own.  With a ``mesh``, this rank's local
    caches of a global batch of ``batch`` rows (`ShardedCaches`)."""
    layout = None if mesh is None else CacheLayout(mesh, cfg, batch,
                                                   max_len)
    caches = []
    for i, c in enumerate(_leaf_shapes(cfg, batch, max_len)):
        parts = tuple({k: torch.zeros(
            shape if layout is None
            else layout.leaves.local_shape(f"layers.{i}.{k}"),
            dtype=dt, device=device) for k, (shape, dt) in part.items()}
            for part in (c if isinstance(c, tuple) else (c,)))
        caches.append(parts if len(parts) > 1 else parts[0])
    return caches if layout is None else ShardedCaches(caches, layout)


def _seq(layout, name: str):
    """(mesh, first position held) when leaf ``name``'s sequence splits
    over ``model``, else None."""
    if layout is None or not layout.split(name, 1):
        return None
    return layout.mesh, layout.seq_base(name)


def _decode_one(p, cache, h, cur_len: int, cfg: ModelConfig,
                shared: Block | None = None, i: int = 0, layout=None,
                params_layout=None):
    if params_layout is not None:
        p = _gathered(p, params_layout, cfg, 1)
    if p.kind in MAMBA_KINDS:
        mc = cache[0] if p.kind == "mamba_attn" else cache
        split = None
        if layout is not None:
            name = f"layers.{i}."
            split = (layout.mesh, layout.split(name + "state", 1),
                     layout.split(name + "conv", 2))
        out, _ = ssm.mamba_decode(
            p.mamba, common.rms_norm(h, p.norm1, cfg.norm_eps), mc, cfg,
            split)
        h = h + out
        if p.kind == "mamba_attn":
            h, _ = _decode_one(shared, cache[1], h, cur_len, cfg, i=i,
                               layout=layout, params_layout=params_layout)
        return h, cache
    name = f"layers.{i}." + ("c" if cfg.attention == "mla" else "k")
    dec = (attention.mla_decode if cfg.attention == "mla"
           else attention.gqa_decode)
    a_out, cache = dec(p.attn, common.rms_norm(h, p.norm1, cfg.norm_eps),
                       cache, cur_len, cfg, _seq(layout, name))
    h = h + a_out
    x = common.rms_norm(h, p.norm2, cfg.norm_eps)
    if layout is not None and p.kind == "moe":
        out, _ = mlp.moe_forward_serve(p.moe, x, cfg, layout.mesh,
                                       layout.rows_view())
    else:
        out, _ = ffn_forward(p, x, cfg)
    return h + out, cache


def _embed_split(params: LM, cfg: ModelConfig, tokens, layout,
                 params_layout):
    """A decode step's embeddings without gathering the (V, D) table: every
    row's tokens are gathered over the row axes, each rank looks them up
    in its own columns of the table (its shard: D split over the data
    axes, or whole), the columns are gathered and the rank keeps its
    rows.  The same values as one device's lookup."""
    mesh = layout.mesh
    tokens = layout.gather_rows(tokens.to(torch.int32))   # ids < 2^31
    h = embed_tokens(fsdp.View(None, {"embedding": params.embedding}), cfg,
                     tokens)
    spec = params_layout.specs["embedding"]
    return layout.rows(fsdp.gather_dim(h, -1, spec[-1], mesh))


def _logits_split(params: LM, cfg: ModelConfig, h, layout, params_layout):
    """A decode step's logits without gathering the (D, V) unembedding
    (tensor parallel, as the table is stored: D over the data axes, V over
    ``model``): every row's normed hidden state is gathered over the row
    axes, each rank multiplies its D block by its shard in float32, the
    partial products are summed over the D axes, the V blocks gathered,
    and the rank keeps its rows, cast to the working dtype."""
    mesh = layout.mesh
    top = _top(params, params_layout, "final_norm")
    h = layout.gather_rows(common.rms_norm(h, top.final_norm, cfg.norm_eps))
    d_entry, v_entry = params_layout.specs["unembed"]
    d_axes = rules.entry_axes(d_entry)
    d = h.shape[-1]
    i, ways = 0, 1
    for a in d_axes:
        i = i * mesh.shape[a] + mesh.axis_index(a)
        ways *= mesh.shape[a]
    part = h[..., i * d // ways:(i + 1) * d // ways].float() \
        @ params.unembed.float()
    if d_axes:
        part = mesh.psum(part, d_axes)
    logits = layout.rows(fsdp.gather_dim(part, -1, v_entry, mesh)) \
        .to(h.dtype)
    if cfg.num_codebooks:
        b, L, _ = logits.shape
        logits = logits.reshape(b, L, cfg.num_codebooks, cfg.vocab_size)
    return logits


def decode_step(params: LM, cfg: ModelConfig, caches: list,
                tokens: torch.Tensor, cur_len: int, mesh=None):
    """One decode step.  tokens: (B, 1) (audio: (B, K, 1)); cur_len: the
    write position (the new token attends positions ≤ cur_len).  Returns
    (logits (B, 1, V[, K]), caches).

    With a ``mesh`` (module docstring), ``params`` holds this rank's
    shards (`fsdp.Layout.shard`; a mesh without a group holds them
    whole), ``caches`` its `ShardedCaches` (`init_caches` or
    `serve.engine.prefill` with the mesh) and ``tokens`` and the logits
    its rows.  The embedding and unembedding tables are never gathered
    there: a step needs a few of their rows or one product with them
    (`_embed_split`, `_logits_split`), where gathering them would move
    both whole tables (1.6 GB of llama3.2-3b's 2 GB) every step."""
    layout = params_layout = None
    if mesh is not None:
        layout = caches.layout
        if mesh.backend is not None:
            params_layout = fsdp.layout_of(params, mesh)
    if params_layout is None:
        h = embed_tokens(params, cfg, tokens)
    else:
        h = _embed_split(params, cfg, tokens, layout, params_layout)
    for i, (layer, cache) in enumerate(zip(params.layers, caches)):
        h, _ = _decode_one(layer, cache, h, cur_len, cfg,
                           params.shared_attn, i, layout, params_layout)
    if params_layout is None:
        return _logits(params, cfg, h), caches
    return _logits_split(params, cfg, h, layout, params_layout), caches
