"""zamba2-2.7b [hybrid] — Mamba2 backbone + ONE weight-shared attention+MLP
block applied every 6 layers (per-invocation LoRA omitted; DESIGN.md).
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32_000, head_dim=80,
    ssm_state=64, hybrid_attn_every=6, rope_theta=10_000.0,
)
