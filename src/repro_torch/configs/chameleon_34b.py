"""chameleon-34b [vlm] — early-fusion, VQ image tokens (arXiv:2405.09818).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Early fusion means
image patches arrive as VQ token ids inside the shared vocab; the VQ-GAN
tokenizer frontend is a STUB (inputs are token ids).
"""
from repro_torch.models.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="chameleon-34b", family=DENSE,
    num_layers=48, d_model=8192, vocab_size=65536,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016,
    param_dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke", family=DENSE,
        num_layers=2, d_model=64, vocab_size=256,
        num_heads=8, num_kv_heads=2, head_dim=8, d_ff=160,
        param_dtype="float32", compute_dtype="float32",
    )
