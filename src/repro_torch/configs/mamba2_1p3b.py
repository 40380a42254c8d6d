"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060].
d_inner = 2*d_model = 4096, ssm head_dim 64 -> 64 heads, conv width 4.
"""
from repro_torch.models.config import ModelConfig, SSM

CONFIG = ModelConfig(
    name="mamba2-1.3b", family=SSM,
    num_layers=48, d_model=2048, vocab_size=50280,
    ssm_state=128, ssm_heads=64, ssm_head_dim=64, ssm_chunk=256,
    ssm_conv=4, ssm_expand=2,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family=SSM,
        num_layers=2, d_model=64, vocab_size=128,
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=16,
        ssm_conv=4, ssm_expand=2, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    )
