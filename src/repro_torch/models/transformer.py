"""Decoder-LM assembly, dense and SSM families (port of
``repro.models.transformer``).

Parameters are a dict under the reference's names — ``embed``,
``blocks``, ``final_norm``, ``lm_head`` — except that ``blocks`` is a
list of per-layer dicts (dense: ``attn_norm``,
``attn.{wq,wk,wv,wo,bq,bk,bv}``, ``ffn_norm``, ``mlp.{gate,up,down}``;
SSM: ``norm``, ``ssm.{in_proj,conv_w,A_log,dt_bias,D,gate_norm,
out_proj}``) where the reference stacks them on a leading L axis for
``lax.scan``; :mod:`repro_torch.models.convert` maps one onto the other.
Layers run in a Python loop.

Public entry points:
  * init_params(cfg, generator)                  -> params
  * forward_logits(params, cfg, inputs)          -> logits, aux
  * prefill(params, cfg, inputs, max_len)        -> last logits, cache
  * decode_step(params, cfg, inputs, cache)      -> logits, cache
  * init_cache(cfg, batch, max_len, dtype, device)

The dense ``prefill`` runs kernel 7 once per layer and its
``decode_step`` kernel 6 once per layer; both take ``attention="plain"``
to run the kernels' twins instead.  The SSM ``prefill`` (and
``forward_logits``) runs kernel 8 once per layer, or its twin with
``ssm="plain"``; its ``decode_step`` is plain PyTorch.  ``decode_step``
writes the new keys and values, or the new SSM states and conv windows,
into the cache in place.  The MoE and hybrid families raise
``NotImplementedError``: they come with a later slice of the port, as
does ``forward_train``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.problem import resolve_device
from .attention import (KVCache, _causal_core, _project_qkv,
                        causal_attention, decode_attention_step,
                        init_attention)
from .config import DENSE, SSM, ModelConfig
from .layers import init_mlp, normal_init, rms_norm, swiglu
from .ssm import SSMCache, conv_dim, init_ssm, ssm_block, ssm_decode_step


class DecodeCache(NamedTuple):
    kv_k: Optional[torch.Tensor]       # (L, B, S_max, Hkv, D)
    kv_v: Optional[torch.Tensor]       # (L, B, S_max, Hkv, D)
    ssm_state: Optional[torch.Tensor]  # (L, B, H, P, N) f32
    ssm_conv: Optional[torch.Tensor]   # (L, B, W-1, conv_dim)
    position: torch.Tensor             # () or (B,) int32 — tokens cached


def _ported(cfg: ModelConfig) -> None:
    if cfg.family not in (DENSE, SSM):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (a "
            f"later slice brings MoE and hybrid); the port runs the dense "
            f"and SSM families")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dtype, dev = cfg.pdtype(), generator.device
    if cfg.family == SSM:
        return {
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "ssm": init_ssm(generator, cfg),
        }
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": init_attention(generator, cfg),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> dict:
    """Random parameters of ``cfg`` (the reference's initializers and
    scales), drawn from ``generator`` on its device.  An int seeds a new
    generator on ``device`` (default: the card)."""
    _ported(cfg)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(int(generator))
    dtype, dev = cfg.pdtype(), generator.device
    blocks = [_init_block(generator, cfg) for _ in range(cfg.num_layers)]
    params = {
        "embed": normal_init(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                             dtype),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
            dtype)
    return params


# SSM leaves the reference reads in f32 whatever the compute dtype
_F32_LEAVES = ("A_log", "dt_bias", "D", "conv_w")


def _keeps_dtype(name: str) -> bool:
    return name.endswith("norm") or name in _F32_LEAVES


def cast_params(params, dtype: torch.dtype):
    """``params`` with every matrix and bias in ``dtype``, and as they are
    the norm weights (``rms_norm`` reads them in f32) and the SSM leaves
    ``A_log``, ``dt_bias``, ``D`` and ``conv_w`` (read in f32).  Every use
    casts a weight to the compute dtype, as the reference does; casting
    once gives the same values and saves the per-step copies (at
    qwen1.5-4b's width ~24 GB of traffic per decode step).  Tensors
    already in ``dtype`` are shared, not copied."""
    if isinstance(params, list):
        return [cast_params(p, dtype) for p in params]
    return {name: (cast_params(value, dtype)
                   if isinstance(value, (dict, list))
                   else value if _keeps_dtype(name) else value.to(dtype))
            for name, value in params.items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _residual(x, h, cfg: ModelConfig):
    if cfg.residual_multiplier != 1.0:    # 1.0 * h is h exactly
        h = cfg.residual_multiplier * h
    return x + h


def _mlp(block: dict, cfg: ModelConfig, x):
    m = block["mlp"]
    return swiglu(rms_norm(x, block["ffn_norm"], cfg.rms_eps),
                  m["gate"], m["up"], m["down"])


def _no_aux(cfg: ModelConfig, device):
    """The reference's MoE statistics, all zero for the dense family."""
    e = max(cfg.num_experts, 1)
    return (torch.zeros((), device=device), torch.zeros((e,), device=device),
            torch.zeros((e, e), device=device))


def backbone(params: dict, cfg: ModelConfig, x, attention: str = "kernel",
             ssm: str = "kernel"):
    """The blocks in order.  x: (B, S, d) -> (B, S, d), aux stats."""
    _ported(cfg)
    if cfg.family == SSM:
        for block in params["blocks"]:
            h, _ = ssm_block(block["ssm"], cfg,
                             rms_norm(x, block["norm"], cfg.rms_eps),
                             ssm=ssm)
            x = _residual(x, h, cfg)
        return x, _no_aux(cfg, x.device)
    for block in params["blocks"]:
        h = causal_attention(
            block["attn"], cfg, rms_norm(x, block["attn_norm"], cfg.rms_eps),
            attention=attention)
        x = _residual(x, h, cfg)
        x = _residual(x, _mlp(block, cfg, x), cfg)
    return x, _no_aux(cfg, x.device)


def embed_inputs(params: dict, cfg: ModelConfig, inputs):
    if cfg.input_kind == "embeddings":
        # modality-frontend stub: inputs ARE (B, S, d) frame embeddings
        x = inputs.to(cfg.cdtype())
    else:
        x = params["embed"][inputs].to(cfg.cdtype())
    if cfg.emb_multiplier != 1.0:          # 1.0 * x is x exactly
        x = x * cfg.emb_multiplier
    return x


def unembed(params: dict, cfg: ModelConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    return logits.to(torch.float32) / cfg.logit_divisor


def forward_logits(params: dict, cfg: ModelConfig, inputs,
                   attention: str = "kernel", ssm: str = "kernel"):
    x = embed_inputs(params, cfg, inputs)
    x, aux = backbone(params, cfg, x, attention, ssm)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), aux


def _prefill_ssm(params: dict, cfg: ModelConfig, x, ssm: str):
    """The SSM arm of prefill: each layer's final state (f32) and conv
    tail (compute dtype), stacked on a leading L axis."""
    b, s = x.shape[0], x.shape[1]
    states = torch.empty((cfg.num_layers, b, cfg.ssm_heads,
                          cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
    convs = torch.empty((cfg.num_layers, b, cfg.ssm_conv - 1, conv_dim(cfg)),
                        dtype=cfg.cdtype(), device=x.device)
    for layer, block in enumerate(params["blocks"]):
        h, states[layer], convs[layer] = ssm_block(
            block["ssm"], cfg, rms_norm(x, block["norm"], cfg.rms_eps),
            return_conv_tail=True, ssm=ssm)
        x = _residual(x, h, cfg)
    cache = DecodeCache(kv_k=None, kv_v=None, ssm_state=states,
                        ssm_conv=convs,
                        position=torch.tensor(s, dtype=torch.int32,
                                              device=x.device))
    return x, cache


def prefill(params: dict, cfg: ModelConfig, inputs, max_len: int,
            attention: str = "kernel", ssm: str = "kernel"):
    """Prefill forward: consumes the prompt, returns (last-token logits
    (B, 1, V), DecodeCache ready for decode_step).  A dense cache holds
    the prompt's keys and values in the compute dtype, padded to
    ``max_len``; an SSM cache each layer's final state (f32) and conv
    window (compute dtype), whatever ``max_len``.  No full-sequence
    logits are built."""
    _ported(cfg)
    x = embed_inputs(params, cfg, inputs)
    if cfg.family == SSM:
        x, cache = _prefill_ssm(params, cfg, x, ssm)
        x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.rms_eps)
        return unembed(params, cfg, x), cache
    b, s = x.shape[0], x.shape[1]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads, cfg.head_dim)
    kv_k = torch.zeros(shape, dtype=cfg.cdtype(), device=x.device)
    kv_v = torch.zeros(shape, dtype=cfg.cdtype(), device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    for layer, block in enumerate(params["blocks"]):
        xn = rms_norm(x, block["attn_norm"], cfg.rms_eps)
        q, k, v = _project_qkv(block["attn"], cfg, xn, positions)
        h = _causal_core(q, k, v, cfg, attention=attention)
        h = h.reshape(b, s, -1) @ block["attn"]["wo"].to(x.dtype)
        x = _residual(x, h, cfg)
        x = _residual(x, _mlp(block, cfg, x), cfg)
        kv_k[layer, :, :s] = k
        kv_v[layer, :, :s] = v
    cache = DecodeCache(kv_k=kv_k, kv_v=kv_v, ssm_state=None, ssm_conv=None,
                        position=torch.tensor(s, dtype=torch.int32,
                                              device=x.device))
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> DecodeCache:
    """An empty cache of ``batch`` rows of ``max_len`` on ``device``
    (default: the card); an SSM cache holds an f32 state and a ``dtype``
    conv window per layer and row, whatever ``max_len``."""
    _ported(cfg)
    device = resolve_device(device)
    if cfg.family == SSM:
        return DecodeCache(
            kv_k=None, kv_v=None,
            ssm_state=torch.zeros((cfg.num_layers, batch, cfg.ssm_heads,
                                   cfg.ssm_head_dim, cfg.ssm_state),
                                  dtype=torch.float32, device=device),
            ssm_conv=torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1,
                                  conv_dim(cfg)), dtype=dtype,
                                 device=device),
            position=torch.zeros((), dtype=torch.int32, device=device))
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return DecodeCache(
        kv_k=torch.zeros(shape, dtype=dtype, device=device),
        kv_v=torch.zeros(shape, dtype=dtype, device=device),
        ssm_state=None, ssm_conv=None,
        position=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params: dict, cfg: ModelConfig, inputs, cache: DecodeCache,
                attention: str = "kernel"):
    """One decode step.  inputs: (B, 1) ids or (B, 1, d) embeddings.
    Writes each layer's new key and value (dense), or its new state and
    conv window (SSM, the window cast to the cache's dtype), into
    ``cache`` in place and returns (logits (B, 1, V), the cache with
    ``position + 1``)."""
    _ported(cfg)
    x = embed_inputs(params, cfg, inputs)
    pos = cache.position
    if cfg.family == SSM:
        for layer, block in enumerate(params["blocks"]):
            h, new = ssm_decode_step(
                block["ssm"], cfg, rms_norm(x, block["norm"], cfg.rms_eps),
                SSMCache(state=cache.ssm_state[layer],
                         conv=cache.ssm_conv[layer]))
            cache.ssm_state[layer] = new.state
            cache.ssm_conv[layer] = new.conv
            x = _residual(x, h, cfg)
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        return unembed(params, cfg, x), cache._replace(position=pos + 1)
    for layer, block in enumerate(params["blocks"]):
        kv_l = KVCache(k=cache.kv_k[layer], v=cache.kv_v[layer],
                       length=pos)
        h, _ = decode_attention_step(
            block["attn"], cfg, rms_norm(x, block["attn_norm"], cfg.rms_eps),
            kv_l, attention=attention)
        x = _residual(x, h, cfg)
        x = _residual(x, _mlp(block, cfg, x), cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), cache._replace(position=pos + 1)
