"""Analytic minimum-HBM-traffic model per (arch x shape) cell (port of
``repro.launch.traffic``, the code copied as it is).

The reference's dry run sets this perfectly-fused FLOOR beside XLA's
unfused ``bytes accessed``; the port's dry run has no compiler to ask, so
the floor is its memory term.  The truth on hardware lies above it.

Model (per chip, per step; tp = model-axis size, dp = chips / tp):

train (microbatched, remat-per-layer, flash-style attention):
  * weights      — FSDP gather write+read per pass per microbatch of the
                   chip's model shard: 2 * 2 * mb * P/tp * bytes_p
  * optimizer    — read grad + m + v, write m + v + p (f32 moments):
                   P/chips * (4 + 4+4 + 4+4 + bytes_p)
  * activations  — saved residuals (seq-sharded): 3 * L * T_loc * d * b_c
                   (write fwd, read bwd, recompute traffic)
  * attention    — flash floor: QKVO streams, ~4 * T_loc * h*hd * b_c * 2
                   passes (the S x S logits never hit HBM)
  * MoE dispatch — routed copies in/out: 4 * T_loc * k * d * b_c per pass

prefill:  weights once + KV-cache write + activation stream.
decode:   weights once per token + KV-cache (or SSM state) read + write.

T_loc = tokens / chips for fully-sharded activations (batch over dp,
sequence over tp — the layout the hints enforce).
"""
from __future__ import annotations

from ..models.config import HYBRID, MOE, SSM


def analytic_traffic(cfg, shape, chips: int, tp: int = 16,
                     microbatches: int = 1) -> dict:
    bytes_p = 2 if cfg.param_dtype == "bfloat16" else 4
    bytes_c = 2 if cfg.compute_dtype == "bfloat16" else 4
    P = cfg.param_count() + cfg.shared_block_params()
    L = cfg.num_layers
    d = cfg.d_model
    dp = max(chips // tp, 1)
    B, S = shape.global_batch, shape.seq_len

    out = {}
    if shape.kind == "train":
        tokens = B * S
        t_loc = tokens / chips
        mb = microbatches
        out["weights"] = 2 * 2 * mb * (P / tp) * bytes_p
        out["optimizer"] = (P / chips) * (4 + 8 + 8 + bytes_p)
        out["activations"] = 3 * L * t_loc * d * bytes_c
        if cfg.num_heads:
            out["attention"] = 2 * 4 * t_loc * cfg.num_heads \
                * cfg.head_dim * bytes_c * (cfg.attention_layers / max(L, 1))
        if cfg.family == MOE:
            out["moe_dispatch"] = 2 * 4 * t_loc * cfg.top_k * d * bytes_c
        if cfg.family in (SSM, HYBRID):
            out["ssm_states"] = 3 * L * (B / dp) * cfg.ssm_heads \
                * cfg.ssm_head_dim * cfg.ssm_state * 4 / tp
    elif shape.kind == "prefill":
        tokens = B * S
        t_loc = tokens / chips
        out["weights"] = 2 * (P / tp) * bytes_p
        out["activations"] = L * t_loc * d * bytes_c * 2
        out["kv_write"] = _cache_bytes(cfg, B, S) / chips
    else:  # decode: one token against a seq_len cache
        out["weights"] = (P / tp) * bytes_p \
            if cfg.family != MOE else (_moe_active_params(cfg, B) / tp) * bytes_p
        out["cache_read"] = _cache_bytes(cfg, B, S) / chips
        out["cache_write"] = _cache_step_bytes(cfg, B) / chips

    out["total"] = sum(out.values())
    return out


def _cache_bytes(cfg, B: int, S: int) -> float:
    """Full KV/SSM cache size (bf16 KV, f32 SSM state)."""
    total = 0.0
    if cfg.attention_layers:
        total += (2 * cfg.attention_layers * B * S * cfg.num_kv_heads
                  * cfg.head_dim * 2)
    if cfg.family in (SSM, HYBRID):
        total += (cfg.num_layers * B * cfg.ssm_heads * cfg.ssm_head_dim
                  * cfg.ssm_state * 4)
        total += cfg.num_layers * B * (cfg.ssm_conv - 1) \
            * (cfg.d_inner + 2 * cfg.ssm_state) * 2
    return total


def _cache_step_bytes(cfg, B: int) -> float:
    """Bytes written per decode step (one new KV slot / state update)."""
    total = 0.0
    if cfg.attention_layers:
        total += 2 * cfg.attention_layers * B * cfg.num_kv_heads \
            * cfg.head_dim * 2
    if cfg.family in (SSM, HYBRID):
        total += cfg.num_layers * B * cfg.ssm_heads * cfg.ssm_head_dim \
            * cfg.ssm_state * 4 * 2      # state read+write
    return total


def _moe_active_params(cfg, batch: int) -> float:
    """Expected parameter bytes touched per decode step: dense part plus
    the experts actually hit by B tokens x top_k draws."""
    expert_p = cfg.num_experts * 3 * cfg.d_model * cfg.d_ff * cfg.num_layers
    dense_p = cfg.param_count() - expert_p
    e = cfg.num_experts
    draws = batch * cfg.top_k
    hit_frac = 1.0 - (1.0 - 1.0 / e) ** draws      # E[experts hit] / e
    return dense_p + expert_p * hit_frac
