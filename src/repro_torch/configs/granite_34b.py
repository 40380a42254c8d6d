"""granite-34b [dense] — llama-arch code model, MQA (arXiv:2405.04324).

88L d_model=6144 48H (GQA kv=1 -> multi-query) d_ff=24576 vocab=49152.
MQA means the KV cache cannot shard over heads; decode shards the cache
sequence dim instead (sharding/rules.py).
"""
from repro_torch.models.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="granite-34b", family=DENSE,
    num_layers=88, d_model=6144, vocab_size=49152,
    num_heads=48, num_kv_heads=1, head_dim=128, d_ff=24576,
    param_dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family=DENSE,
        num_layers=2, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=192,
        param_dtype="float32", compute_dtype="float32",
    )
