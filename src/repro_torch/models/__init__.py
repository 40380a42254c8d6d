"""The LM stack (port of ``repro.models``): configuration, layers, GQA
attention on kernels 6–7, the Mamba2 block on kernel 8, the MoE block, and
the prefill and decode of all four families (dense, MoE, SSM, hybrid)."""
from . import moe  # noqa: F401
from .config import DENSE, HYBRID, MOE, SSM, ModelConfig  # noqa: F401
from .transformer import (  # noqa: F401
    DecodeCache,
    cast_params,
    decode_step,
    forward_logits,
    forward_train,
    init_cache,
    init_params,
    prefill,
)
