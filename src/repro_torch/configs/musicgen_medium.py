"""musicgen-medium [audio] — decoder-only over EnCodec tokens, 4 codebooks
(sum-of-embeddings in, one head per codebook out); EnCodec itself stubbed.
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    activation="gelu", gated_mlp=False, num_codebooks=4,
    rope_theta=10_000.0,
)
