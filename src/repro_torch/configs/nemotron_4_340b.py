"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP (ungated).
[arXiv:2402.16819; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256_000, head_dim=192,
    activation="relu2", gated_mlp=False, rope_theta=10_000.0,
    optimizer_state_dtype="bfloat16",
)
