"""Model configuration for the assigned architecture pool (port of
``repro.models.config``, kept as its own copy because the reference module
imports JAX).

One dataclass covers all four families (dense / moe / ssm / hybrid); each
``repro_torch/configs/<arch>.py`` instantiates it with the exact published
numbers and a reduced ``smoke()`` variant for CPU tests.  Only
``pdtype()``/``cdtype()`` differ from the reference: they return
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses

import torch

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (unused by pure-SSM archs)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    d_ff: int = 0
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 256        # dispatch-group length (tokens)
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"        # scatter | dense (dense = oracle)
    router_aux_coef: float = 0.01
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (Zamba2-style shared attention)
    attn_period: int = 0             # insert shared attn block every N layers
    # attention blocking in the reference (q in chunks so the SxS logits
    # never materialize); accepted and without effect in the port, whose
    # prefill kernel never builds the SxS logits
    attn_q_chunks: int = 1
    # normalization / scaling
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    emb_multiplier: float = 1.0      # MiniCPM mu-P style scaling
    residual_multiplier: float = 1.0
    logit_divisor: float = 1.0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # modality frontend: "tokens" (ids) or "embeddings" (stub frontend
    # supplies precomputed frame/patch embeddings)
    input_kind: str = "tokens"
    remat: bool = True

    # ----- derived -----------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attention_layers(self) -> int:
        if self.family == SSM:
            return 0
        if self.family == HYBRID:
            return 0 if self.attn_period == 0 else \
                len(range(self.attn_period - 1, self.num_layers,
                          self.attn_period))
        return self.num_layers

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (SSM/hybrid state)."""
        return self.family in (SSM, HYBRID)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    # ----- parameter / FLOP accounting (roofline §Roofline) -------------
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                   # lm head
        n += self.num_layers * self._block_params()
        n += d                                          # final norm
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        hd = self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias + d                   # + input norm

    def _mlp_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff + self.d_model  # SwiGLU + norm

    def _moe_params(self) -> int:
        return (self.num_experts * 3 * self.d_model * self.d_ff
                + self.d_model * self.num_experts      # router
                + self.d_model)                        # norm

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g = 1                                          # single B/C group
        conv_dim = di + 2 * g * self.ssm_state
        n = d * (2 * di + 2 * g * self.ssm_state + self.ssm_heads)  # in_proj
        n += conv_dim * self.ssm_conv                  # depthwise conv
        n += self.ssm_heads * 2                        # A_log, D
        n += self.ssm_heads                            # dt_bias
        n += di                                        # gate norm
        n += di * d                                    # out_proj
        n += d                                         # input norm
        return n

    def _block_params(self) -> int:
        if self.family == DENSE:
            return self._attn_params() + self._mlp_params(self.d_ff)
        if self.family == MOE:
            return self._attn_params() + self._moe_params()
        if self.family == SSM:
            return self._ssm_params()
        if self.family == HYBRID:
            # per-layer mamba params; the shared attn+mlp block is counted
            # once (amortized here as a separate term in param_count via
            # shared_block_params()).
            return self._ssm_params()
        raise ValueError(self.family)

    def shared_block_params(self) -> int:
        if self.family != HYBRID or self.attn_period == 0:
            return 0
        return self._attn_params() + self._mlp_params(self.d_ff)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts experts)."""
        if self.family != MOE:
            return self.param_count() + self.shared_block_params()
        dense_part = self.param_count() - self.num_layers * (
            self.num_experts * 3 * self.d_model * self.d_ff)
        active_experts = self.num_layers * self.top_k * 3 * self.d_model * self.d_ff
        return dense_part + active_experts
