"""musicgen-medium [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284).  Backbone only: the EnCodec frontend is a STUB —
input_specs() supplies precomputed frame embeddings (B, S, d_model).

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
"""
from repro_torch.models.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="musicgen-medium", family=DENSE,
    num_layers=48, d_model=1536, vocab_size=2048,
    num_heads=24, num_kv_heads=24, head_dim=64, d_ff=6144,
    input_kind="embeddings",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family=DENSE,
        num_layers=2, d_model=64, vocab_size=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        input_kind="embeddings",
        param_dtype="float32", compute_dtype="float32",
    )
