"""qwen1.5-110b [dense] — GQA with QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152_064, qkv_bias=True,
    rope_theta=1_000_000.0, optimizer_state_dtype="bfloat16",
)
