"""command-r-35b [dense] — GQA, no bias. [hf:CohereForAI/c4ai-command-r-v01;
unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256_000, rope_theta=8_000_000.0,
)
