"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280, attention="none",
    ssm_state=128,
)
