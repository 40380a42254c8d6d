"""The LM stack (port of ``repro.models``): configuration, layers, GQA
attention on kernels 6–7, the Mamba2 block on kernel 8, and the dense and
SSM decoders' prefill and decode."""
from .config import DENSE, HYBRID, MOE, SSM, ModelConfig  # noqa: F401
from .transformer import (  # noqa: F401
    DecodeCache,
    cast_params,
    decode_step,
    forward_logits,
    init_cache,
    init_params,
    prefill,
)
