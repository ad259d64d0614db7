"""Model configuration of the LM substrate (a copy of the reference's
``models/config.py::ModelConfig``).

One dataclass covers every family (dense / MoE / SSM / hybrid / VLM / audio);
family-specific fields default to inert values.  Configs are plain data — the
model code (models/model.py) interprets them; launch code looks them up via
``repro_torch.configs.registry``.  The port runs every block kind and
phi-3-vision's patch embeddings (``num_patches``).  ``remat`` checkpoints
each layer of a training forward (`models.model.forward`); ``scan_layers``,
``fsdp_per_layer_gather`` and the ``attn_block_*`` / ``attention_impl``
knobs tune the reference's XLA lowering and have no counterpart in the
port.  `ShapeConfig` and `SHAPES` are the reference's input-shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 ⇒ d_model // num_heads

    # --- attention flavor ---
    attention: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP flavor ---
    activation: str = "silu"         # silu | gelu | relu2 (squared ReLU)
    gated_mlp: bool = True           # SwiGLU-style gate (False: plain MLP)

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert FFN width
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # leading dense layers (deepseek: 3)
    moe_every: int = 1               # MoE block every N layers (llama4: 1)
    moe_impl: str = "a2a"            # a2a (shard_map EP) | scatter (GSPMD)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0               # v-heads of SSD (0 ⇒ d_model // 64)
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_expand: int = 2

    # --- hybrid (zamba2): shared attention block every N mamba layers ---
    hybrid_attn_every: int = 0

    # --- modality stubs ---
    num_patches: int = 0             # VLM: prefix patch embeddings
    num_codebooks: int = 0           # audio: EnCodec codebooks

    # --- training/runtime knobs ---
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    fsdp_per_layer_gather: bool = True   # constrain per-layer param slices
    # inside the scan so FSDP gathers stream layer-by-layer (§Perf N1)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    optimizer_state_dtype: str = "float32"   # bf16 for the ≥100B configs
    attention_impl: str = "blocked_scan"     # blocked_scan | pallas | naive
    attn_block_q: int = 512
    attn_block_k: int = 1024

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("ssm", "hybrid") and self.ssm_heads == 0:
            object.__setattr__(self, "ssm_heads",
                               (self.d_model * self.ssm_expand) // 64)

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d                                    # embed
        if not self.tie_embeddings:
            n += v * d                               # unembed
        for layer in range(self.num_layers):
            n += self._layer_params(layer)
        n += d                                       # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        d, v = self.d_model, self.vocab_size
        n = 2 * v * d if not self.tie_embeddings else v * d
        for layer in range(self.num_layers):
            n += self._layer_params(layer, active_only=True)
        return n + d

    def _layer_params(self, layer: int, active_only: bool = False) -> int:
        d, f = self.d_model, self.d_ff
        n = 2 * d                                    # norms
        if self.family in ("ssm",) or (
                self.family == "hybrid" and True):
            # mamba2 block params
            di, s = self.d_inner, self.ssm_state
            heads = self.ssm_heads
            n_m = d * (2 * di + 2 * s * 1 + heads)   # in_proj(z,x)+B,C+dt
            n_m += di * d                            # out_proj
            n_m += self.conv_width * (di + 2 * s)    # conv
            n_m += 2 * heads                         # A, D
            if self.family == "ssm":
                return n + n_m
            # hybrid: mamba every layer + shared attn params counted once
            n += n_m
            if self.hybrid_attn_every and layer == 0:
                hd = self.head_dim
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                n += self.num_heads * hd * d
                n += 3 * d * f                       # shared MLP
            return n
        # attention
        hd = self.head_dim
        if self.attention == "mla":
            qr, kr, rd, vd = (self.q_lora_rank, self.kv_lora_rank,
                              self.rope_head_dim, self.v_head_dim or hd)
            n += d * qr + qr * self.num_heads * (hd + rd)
            n += d * (kr + rd) + kr * self.num_heads * (hd + vd)
            n += self.num_heads * vd * d
            n += qr + kr                             # latent norms
        else:
            n += d * hd * (self.num_heads + 2 * self.num_kv_heads)
            n += self.num_heads * hd * d
            if self.qkv_bias:
                n += hd * (self.num_heads + 2 * self.num_kv_heads)
        # mlp / moe
        is_moe = (self.num_experts > 0 and layer >= self.first_dense_layers
                  and (layer % self.moe_every == 0 or self.moe_every == 1))
        if is_moe:
            fe = self.moe_d_ff or f
            per_expert = (3 if self.gated_mlp else 2) * d * fe
            n += d * self.num_experts                # router
            n += self.num_shared_experts * (3 if self.gated_mlp else 2) * d * f
            experts = (self.top_k if active_only else self.num_experts)
            n += experts * per_expert
        else:
            n += (3 if self.gated_mlp else 2) * d * f
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what to run and at what size."""
    name: str                        # train_4k | prefill_32k | ...
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: Optional[int] = None  # grad-accum microbatch (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# long_500k requires sub-quadratic sequence mixing: only the SSM/hybrid
# archs run it; pure-attention archs record an explicit skip.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")
