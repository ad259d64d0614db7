"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared,
interleaved dense/MoE (every other layer).  Early-fusion frontend stubbed.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202_048, head_dim=128,
    num_experts=128, num_shared_experts=1, top_k=1, moe_d_ff=8192,
    moe_every=2, rope_theta=500_000.0,
    optimizer_state_dtype="bfloat16",
)
