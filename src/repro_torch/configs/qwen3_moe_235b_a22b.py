"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8 routing.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-235B-A22B; head_dim=128 per the HF config].
"""
from repro_torch.models.config import ModelConfig, MOE

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family=MOE,
    num_layers=94, d_model=4096, vocab_size=151936,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
    num_experts=128, top_k=8, moe_group_size=512, capacity_factor=1.25,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family=MOE,
        num_layers=2, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96,
        num_experts=8, top_k=2, moe_group_size=16, capacity_factor=1.25,
        param_dtype="float32", compute_dtype="float32",
    )
