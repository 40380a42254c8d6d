"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-4B].

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936, head_dim=128.
"""
from repro_torch.models.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen1.5-4b", family=DENSE,
    num_layers=40, d_model=2560, vocab_size=151936,
    num_heads=20, num_kv_heads=20, head_dim=128, d_ff=6912,
    qkv_bias=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family=DENSE,
        num_layers=2, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        qkv_bias=True,
        param_dtype="float32", compute_dtype="float32",
    )
