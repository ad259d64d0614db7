"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts,
3 leading dense layers.  MTP head omitted (DESIGN.md §Arch-applicability).
[arXiv:2412.19437; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129_280,
    attention="mla", head_dim=128, v_head_dim=128,
    q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
    num_experts=256, num_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3, rope_theta=10_000.0,
    optimizer_state_dtype="bfloat16",
)
