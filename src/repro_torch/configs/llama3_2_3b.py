"""llama3.2-3b [dense] — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128_256, head_dim=128, rope_theta=500_000.0,
)
