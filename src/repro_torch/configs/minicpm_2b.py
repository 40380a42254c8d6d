"""minicpm-2b [dense] — WSD schedule, mu-P style scaling (arXiv:2404.06395).

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
Scaling: emb x12, residual x(1.4/sqrt(40)), logits /(d_model/256).
The WSD (warmup-stable-decay) LR schedule lives in training/optimizer.py.
"""
from repro_torch.models.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="minicpm-2b", family=DENSE,
    num_layers=40, d_model=2304, vocab_size=122753,
    num_heads=36, num_kv_heads=36, head_dim=64, d_ff=5760,
    tie_embeddings=True,
    emb_multiplier=12.0,
    residual_multiplier=1.4 / (40 ** 0.5),
    logit_divisor=2304 / 256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", family=DENSE,
        num_layers=2, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        tie_embeddings=True, emb_multiplier=12.0,
        residual_multiplier=1.4 / (2 ** 0.5), logit_divisor=64 / 256,
        param_dtype="float32", compute_dtype="float32",
    )
