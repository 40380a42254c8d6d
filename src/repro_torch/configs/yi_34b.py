"""yi-34b [dense] — llama-arch GQA (arXiv:2403.04652).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, head_dim=128.
"""
from repro_torch.models.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="yi-34b", family=DENSE,
    num_layers=60, d_model=7168, vocab_size=64000,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480,
    rope_theta=5_000_000.0,
    param_dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", family=DENSE,
        num_layers=2, d_model=64, vocab_size=128,
        num_heads=8, num_kv_heads=2, head_dim=8, d_ff=192,
        param_dtype="float32", compute_dtype="float32",
    )
