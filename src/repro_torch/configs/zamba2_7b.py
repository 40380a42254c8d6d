"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
(arXiv:2411.15242).

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
d_inner = 7168, ssm head_dim 64 -> 112 ssm heads.  One SHARED attn+MLP
block (weights reused) applied every 6 Mamba2 layers (13 applications);
only those applications hold KV cache, so 524k-token decode stays cheap.
"""
from repro_torch.models.config import ModelConfig, HYBRID

CONFIG = ModelConfig(
    name="zamba2-7b", family=HYBRID,
    num_layers=81, d_model=3584, vocab_size=32000,
    num_heads=32, num_kv_heads=32, head_dim=112, d_ff=14336,
    ssm_state=64, ssm_heads=112, ssm_head_dim=64, ssm_chunk=256,
    ssm_conv=4, ssm_expand=2,
    attn_period=6,
    param_dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family=HYBRID,
        num_layers=4, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=16,
        ssm_conv=4, ssm_expand=2, attn_period=2,
        param_dtype="float32", compute_dtype="float32",
    )
