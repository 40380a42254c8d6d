"""granite-moe-1b-a400m [moe] — 32 experts, top-8 routing.

24L d_model=1024 16H (GQA kv=8) expert d_ff=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.models.config import ModelConfig, MOE

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family=MOE,
    num_layers=24, d_model=1024, vocab_size=49155,
    num_heads=16, num_kv_heads=8, head_dim=64, d_ff=512,
    num_experts=32, top_k=8, moe_group_size=512, capacity_factor=1.25,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family=MOE,
        num_layers=2, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64,
        num_experts=4, top_k=2, moe_group_size=16, capacity_factor=1.5,
        tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    )
