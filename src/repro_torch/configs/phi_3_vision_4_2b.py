"""phi-3-vision-4.2b [vlm] — phi3-mini backbone; CLIP frontend is a stub:
input_specs() supplies 64 precomputed patch embeddings (1024-d) that a
learned projection prepends to the text sequence.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32_064, head_dim=96,
    num_patches=64, rope_theta=10_000.0,
)
