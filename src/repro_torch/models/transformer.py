"""Decoder-LM assembly for all four families (port of
``repro.models.transformer``).

Parameters are a dict under the reference's names — ``embed``,
``blocks``, ``final_norm``, ``lm_head``, and a hybrid's ``shared`` —
except that ``blocks`` is a list of per-layer dicts (dense: ``attn_norm``,
``attn.{wq,wk,wv,wo,bq,bk,bv}``, ``ffn_norm``, ``mlp.{gate,up,down}``;
MoE: the same with ``moe.{router,gate,up,down}`` in place of ``mlp``;
SSM and hybrid: ``norm``, ``ssm.{in_proj,conv_w,A_log,dt_bias,D,
gate_norm,out_proj}``) where the reference stacks them on a leading L axis
for ``lax.scan``; :mod:`repro_torch.models.convert` maps one onto the
other.  Layers run in a Python loop.  A hybrid (Zamba2-style) applies its
one ``shared`` attention+MLP block after every layer l with
``(l + 1) % attn_period == 0``; only those applications hold a KV cache.

Public entry points:
  * init_params(cfg, generator)                  -> params
  * forward_train(params, cfg, batch)            -> loss, metrics
  * forward_logits(params, cfg, inputs)          -> logits, aux
  * prefill(params, cfg, inputs, max_len)        -> last logits, cache
  * decode_step(params, cfg, inputs, cache)      -> logits, cache
  * init_cache(cfg, batch, max_len, dtype, device)

Every attention layer (dense, MoE, and the hybrid's shared block) runs
kernel 7 in ``prefill`` and ``forward_logits`` and kernel 6 in
``decode_step``; ``attention="plain"`` runs the kernels' twins instead.
Every Mamba2 layer (SSM, hybrid) runs kernel 8 in ``prefill`` and
``forward_logits``, or its twin with ``ssm="plain"``; its decode step is
plain PyTorch.  An MoE block drops (token, slot) pairs past the config's
capacity in ``forward_logits`` and ``prefill`` and is dropless in
``decode_step``, as the reference.  ``decode_step`` writes the new keys
and values, SSM states and conv windows into the cache in place.

The residual stream is hinted sequence-parallel (``sharding.hints.hint``)
at the top of each layer of ``backbone``, where the reference's scanned
block hints it, and of ``prefill``'s loops; under a mesh each layer's
normed input is gathered over its sequence for its matmuls (``_norm``).
Under a mesh (the dry run, a DTensor activation) ``prefill`` builds its
cache out of place, by
stacking the layers' keys, values, states and windows, and
``decode_step`` writes its new entries out of place and returns a cache
of new tensors: DTensor cannot copy a sharded tensor into a plain one or
write in place across placements.  With no mesh active every hint
returns its input and these branches are not taken, so a path on one
card runs the ops it ran before.

``forward_train`` is the training loss.  Under autograd the kernels stay
in the forward and their backward recomputes the plain formula
(:mod:`repro_torch.models.attention`, :mod:`repro_torch.models.ssm`);
with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint.checkpoint`` (the reference's ``jax.checkpoint``
of its scanned block), so its kernels run twice a step.  A path that
records no gradient runs exactly the ops it ran before.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.problem import resolve_device
from ..sharding.hints import DP, hint, on_mesh, relayout
from .attention import (KVCache, _causal_core, _project_out, _project_qkv,
                        causal_attention, decode_attention_step,
                        init_attention)
from .config import DENSE, HYBRID, MOE, SSM, ModelConfig
from .layers import init_mlp, normal_init, rms_norm, swiglu
from .moe import init_moe, moe_block
from .ssm import SSMCache, conv_dim, init_ssm, ssm_block, ssm_decode_step


class DecodeCache(NamedTuple):
    kv_k: Optional[torch.Tensor]       # (L_attn, B, S_max, Hkv, D)
    kv_v: Optional[torch.Tensor]       # (L_attn, B, S_max, Hkv, D)
    ssm_state: Optional[torch.Tensor]  # (L, B, H, P, N) f32
    ssm_conv: Optional[torch.Tensor]   # (L, B, W-1, conv_dim)
    position: torch.Tensor             # () or (B,) int32 — tokens cached


def _mamba_layers(cfg: ModelConfig) -> bool:
    """True for the families built of Mamba2 layers (SSM, hybrid), False
    for those built of attention layers (dense, MoE); raises on any other
    family."""
    if cfg.family in (SSM, HYBRID):
        return True
    if cfg.family in (DENSE, MOE):
        return False
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                     f"families are {DENSE}, {MOE}, {SSM} and {HYBRID}")


def _shared_after(cfg: ModelConfig, layer: int) -> bool:
    """Whether a hybrid applies its shared block after ``layer``."""
    return cfg.family == HYBRID and cfg.attn_period > 0 \
        and (layer + 1) % cfg.attn_period == 0


def _attention_layer_index(cfg: ModelConfig) -> list[int]:
    """Layer index -> index into a hybrid's stacked shared-attention KV
    cache (0 where the shared block does not run)."""
    ids, count = [], 0
    for layer in range(cfg.num_layers):
        ids.append(count if _shared_after(cfg, layer) else 0)
        count += _shared_after(cfg, layer)
    return ids


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attention_block(generator: torch.Generator, cfg: ModelConfig,
                          ffn: str, dev: torch.device) -> dict:
    dtype = cfg.pdtype()
    block = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": init_attention(generator, cfg, dev),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    block[ffn] = init_moe(generator, cfg, dev) if ffn == "moe" \
        else init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, dev)
    return block


def _init_block(generator: torch.Generator, cfg: ModelConfig,
                dev: torch.device) -> dict:
    if _mamba_layers(cfg):
        return {
            "norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype(),
                               device=dev),
            "ssm": init_ssm(generator, cfg, dev),
        }
    return _init_attention_block(generator, cfg,
                                 "moe" if cfg.family == MOE else "mlp", dev)


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> dict:
    """Random parameters of ``cfg`` (the reference's initializers and
    scales), drawn from ``generator``: on ``device`` when one is given,
    else on the generator's device.  An int seeds a new generator on
    ``device`` (default: the card).  ``device="meta"`` builds the
    abstract tree the dry run shards (shapes and dtypes, no storage);
    there is no meta generator, so its draws take a CPU one."""
    if not isinstance(generator, torch.Generator):
        gen_dev = resolve_device(device)
        generator = torch.Generator(
            device="cpu" if gen_dev.type == "meta" else gen_dev
        ).manual_seed(int(generator))
    dev = generator.device if device is None else torch.device(device)
    dtype = cfg.pdtype()
    blocks = [_init_block(generator, cfg, dev)
              for _ in range(cfg.num_layers)]
    params = {
        "embed": normal_init(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                             dtype, dev),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
            dtype, dev)
    if cfg.family == HYBRID and cfg.attn_period > 0:
        params["shared"] = _init_attention_block(generator, cfg, "mlp", dev)
    return params


# leaves the reference reads in f32 whatever the compute dtype: the SSM's
# and the MoE router (rounding it would change the routing)
_F32_LEAVES = ("A_log", "dt_bias", "D", "conv_w", "router")


def _keeps_dtype(name: str) -> bool:
    return name.endswith("norm") or name in _F32_LEAVES


def cast_params(params, dtype: torch.dtype):
    """``params`` with every matrix and bias in ``dtype``, and as they are
    the norm weights (``rms_norm`` reads them in f32), the SSM leaves
    ``A_log``, ``dt_bias``, ``D`` and ``conv_w`` and the MoE ``router``
    (read in f32).  Every use casts a weight to the compute dtype, as the
    reference does; casting once gives the same values and saves the
    per-step copies (at qwen1.5-4b's width ~24 GB of traffic per decode
    step).  Tensors already in ``dtype`` are shared, not copied."""
    if isinstance(params, list):
        return [cast_params(p, dtype) for p in params]
    return {name: (cast_params(value, dtype)
                   if isinstance(value, (dict, list))
                   else value if _keeps_dtype(name) else value.to(dtype))
            for name, value in params.items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _norm(x, weight, cfg: ModelConfig):
    """``rms_norm(x)``, the input of a layer's matmuls.  Under a mesh it is
    gathered over its sequence (``relayout``), as the reference's
    partitioner gathers a sequence-parallel residual for a tensor-parallel
    matmul: a matmul flattens (B, S), and a sequence sharded over 'model'
    flattens to a strided shard, whose redistributions DTensor plans by a
    graph search that takes minutes an op on a three-axis mesh."""
    return relayout(rms_norm(x, weight, cfg.rms_eps), DP, None, None)


def _residual(x, h, cfg: ModelConfig):
    if cfg.residual_multiplier != 1.0:    # 1.0 * h is h exactly
        h = cfg.residual_multiplier * h
    return x + h


def _ffn(block: dict, cfg: ModelConfig, x, dropless: bool = False):
    """The block's feed-forward half on ``rms_norm(x)``: its MoE (with its
    statistics) or its SwiGLU MLP (statistics None)."""
    xn = _norm(x, block["ffn_norm"], cfg)
    if "moe" in block:
        return moe_block(block["moe"], cfg, xn, dropless=dropless)
    m = block["mlp"]
    return swiglu(xn, m["gate"], m["up"], m["down"]), None


def _attention_block(block: dict, cfg: ModelConfig, x, attention: str):
    """A dense or MoE layer, or a hybrid's shared block, on the full
    sequence: x -> x, MoE statistics (None without an MoE)."""
    h = causal_attention(
        block["attn"], cfg, _norm(x, block["attn_norm"], cfg),
        attention=attention)
    x = _residual(x, h, cfg)
    h, stats = _ffn(block, cfg, x)
    return _residual(x, h, cfg), stats


def _no_aux(cfg: ModelConfig, device):
    """The reference's MoE statistics, all zero for the families without
    an MoE."""
    e = max(cfg.num_experts, 1)
    return (torch.zeros((), device=device), torch.zeros((e,), device=device),
            torch.zeros((e, e), device=device))


def _mamba_layer(params: dict, cfg: ModelConfig, layer: int, x,
                 attention: str, ssm: str):
    """Mamba2 layer ``layer`` on the full sequence, and a hybrid's shared
    block after it where it applies."""
    x = hint(x, DP, "model", None)
    block = params["blocks"][layer]
    h, _ = ssm_block(block["ssm"], cfg,
                     _norm(x, block["norm"], cfg), ssm=ssm)
    x = _residual(x, h, cfg)
    if _shared_after(cfg, layer):
        x, _ = _attention_block(params["shared"], cfg, x, attention)
    return x


def _records(x, params: dict, layer: int) -> bool:
    """Whether autograd records layer ``layer``: grad mode is on and its
    input or a weight it reads requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    stack = [x, params["blocks"][layer], params.get("shared", {})]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif node.requires_grad:
            return True
    return False


def _layer(fn, params: dict, cfg: ModelConfig, layer: int, x, *args):
    """``fn(params, cfg, layer, x, *args)``, under activation
    checkpointing when ``cfg.remat`` and autograd records the layer."""
    if cfg.remat and _records(x, params, layer):
        return checkpoint(fn, params, cfg, layer, x, *args,
                          use_reentrant=False)
    return fn(params, cfg, layer, x, *args)


def _dense_layer(params: dict, cfg: ModelConfig, layer: int, x,
                 attention: str):
    x = hint(x, DP, "model", None)
    return _attention_block(params["blocks"][layer], cfg, x, attention)


def backbone(params: dict, cfg: ModelConfig, x, attention: str = "kernel",
             ssm: str = "kernel"):
    """The blocks in order.  x: (B, S, d) -> (B, S, d), aux stats: an
    MoE's auxiliary loss summed over the layers, its expert load averaged
    over them and its co-activation counts summed; zeros for the other
    families."""
    if _mamba_layers(cfg):
        for layer in range(len(params["blocks"])):
            x = _layer(_mamba_layer, params, cfg, layer, x, attention, ssm)
        return x, _no_aux(cfg, x.device)
    stats = []
    for layer in range(len(params["blocks"])):
        x, layer_stats = _layer(_dense_layer, params, cfg, layer, x,
                                attention)
        stats.append(layer_stats)
    if cfg.family != MOE:
        return x, _no_aux(cfg, x.device)
    aux, load, coact = (torch.stack(v) for v in zip(*stats))
    return x, (torch.sum(aux), torch.mean(load, dim=0),
               torch.sum(coact, dim=0))


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
    x = _norm(x, params["final_norm"], cfg)
    return unembed(params, cfg, x), aux


def forward_train(params: dict, cfg: ModelConfig, batch: dict,
                  attention: str = "kernel", ssm: str = "kernel"):
    """batch: {"inputs": ids or embeddings, "targets": (B, S) ids, and an
    optional "mask" (B, S)}.  Returns (loss, metrics dict): the masked
    mean cross-entropy plus ``router_aux_coef`` times an MoE's auxiliary
    loss, and the router's statistics."""
    logits, (aux_loss, expert_load, coact) = forward_logits(
        params, cfg, batch["inputs"], attention, ssm)
    logp = torch.log_softmax(logits, dim=-1)
    targets = batch["targets"].to(torch.int64)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = ce + cfg.router_aux_coef * aux_loss
    return loss, {"ce": ce, "aux_loss": aux_loss,
                  "expert_load": expert_load, "coactivation": coact}


def _prefill_attention(block: dict, cfg: ModelConfig, x, kv, slot: int,
                       attention: str):
    """``_attention_block`` that also writes the prompt's keys and values
    into ``kv[0][slot]``, ``kv[1][slot]`` (under a mesh, appends them to
    the lists ``kv``); MoE statistics are dropped."""
    s = x.shape[1]
    xn = _norm(x, block["attn_norm"], cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(block["attn"], cfg, xn, positions)
    h = _project_out(block["attn"], _causal_core(q, k, v, cfg,
                                                 attention=attention),
                     x.dtype)
    x = _residual(x, h, cfg)
    h, _ = _ffn(block, cfg, x)
    if isinstance(kv[0], list):
        kv[0].append(k)
        kv[1].append(v)
    else:
        kv[0][slot, :, :s] = k
        kv[1][slot, :, :s] = v
    return _residual(x, h, cfg)


def prefill(params: dict, cfg: ModelConfig, inputs, max_len: int,
            attention: str = "kernel", ssm: str = "kernel"):
    """Prefill forward: consumes the prompt, returns (last-token logits
    (B, 1, V), DecodeCache ready for decode_step).  The cache holds each
    attention layer's keys and values in the compute dtype, padded to
    ``max_len``, and each Mamba2 layer's final state (f32) and conv
    window (compute dtype), whatever ``max_len``.  No full-sequence
    logits are built."""
    mamba = _mamba_layers(cfg)
    x = embed_inputs(params, cfg, inputs)
    b, s = x.shape[0], x.shape[1]
    mesh = on_mesh(x)
    kv = (None, None)
    if cfg.attention_layers:
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds "
                             f"max_len={max_len}")
        shape = (cfg.attention_layers, b, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        kv = ([], []) if mesh else tuple(
            torch.zeros(shape, dtype=cfg.cdtype(), device=x.device)
            for _ in "kv")
    states = convs = None
    if mamba:
        if mesh:
            states, convs = [], []
        else:
            states = torch.empty((cfg.num_layers, b, cfg.ssm_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=x.device)
            convs = torch.empty((cfg.num_layers, b, cfg.ssm_conv - 1,
                                 conv_dim(cfg)), dtype=cfg.cdtype(),
                                device=x.device)
        kv_index = _attention_layer_index(cfg)
        for layer, block in enumerate(params["blocks"]):
            x = hint(x, DP, "model", None)
            h, state, conv = ssm_block(
                block["ssm"], cfg, _norm(x, block["norm"], cfg),
                return_conv_tail=True, ssm=ssm)
            if mesh:
                states.append(state)
                convs.append(conv.to(cfg.cdtype()))
            else:
                states[layer], convs[layer] = state, conv
            x = _residual(x, h, cfg)
            if _shared_after(cfg, layer):
                x = _prefill_attention(params["shared"], cfg, x, kv,
                                       kv_index[layer], attention)
    else:
        for layer, block in enumerate(params["blocks"]):
            x = hint(x, DP, "model", None)
            x = _prefill_attention(block, cfg, x, kv, layer, attention)
    if mesh:
        pad = (0, 0, 0, 0, 0, max_len - s)
        kv = tuple(None if t is None else torch.stack(
            [torch.nn.functional.pad(e, pad).to(cfg.cdtype()) for e in t])
            for t in kv)
        states = None if states is None else torch.stack(states)
        convs = None if convs is None else torch.stack(convs)
    cache = DecodeCache(kv_k=kv[0], kv_v=kv[1], ssm_state=states,
                        ssm_conv=convs,
                        position=torch.tensor(s, dtype=torch.int32,
                                              device=x.device))
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> DecodeCache:
    """An empty cache of ``batch`` rows on ``device`` (default: the
    card): ``dtype`` keys and values of ``max_len`` positions for each
    attention layer (a hybrid's: each application of its shared block),
    and an f32 state and a ``dtype`` conv window for each Mamba2 layer,
    whatever ``max_len``."""
    mamba = _mamba_layers(cfg)
    device = resolve_device(device)
    kv_k = kv_v = ssm_state = ssm_conv = None
    if cfg.attention_layers:
        shape = (cfg.attention_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        kv_k = torch.zeros(shape, dtype=dtype, device=device)
        kv_v = torch.zeros(shape, dtype=dtype, device=device)
    if mamba:
        ssm_state = torch.zeros((cfg.num_layers, batch, cfg.ssm_heads,
                                 cfg.ssm_head_dim, cfg.ssm_state),
                                dtype=torch.float32, device=device)
        ssm_conv = torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1,
                                conv_dim(cfg)), dtype=dtype, device=device)
    return DecodeCache(kv_k=kv_k, kv_v=kv_v, ssm_state=ssm_state,
                       ssm_conv=ssm_conv,
                       position=torch.zeros((), dtype=torch.int32,
                                            device=device))


def _decode_attention(block: dict, cfg: ModelConfig, x, cache: DecodeCache,
                      slot: int, attention: str):
    """One token through an attention layer (or a hybrid's shared block)
    whose keys and values are ``cache``'s entry ``slot``; an MoE runs
    dropless.  Returns x and the layer's cache (``cache``'s own entry but
    under a mesh, where it is written out of place)."""
    kv_l = KVCache(k=cache.kv_k[slot], v=cache.kv_v[slot],
                   length=cache.position)
    h, kv_l = decode_attention_step(
        block["attn"], cfg, rms_norm(x, block["attn_norm"], cfg.rms_eps),
        kv_l, attention=attention)
    x = _residual(x, h, cfg)
    h, _ = _ffn(block, cfg, x, dropless=True)
    return _residual(x, h, cfg), kv_l


def decode_step(params: dict, cfg: ModelConfig, inputs, cache: DecodeCache,
                attention: str = "kernel"):
    """One decode step.  inputs: (B, 1) ids or (B, 1, d) embeddings.
    Writes each attention layer's new key and value and each Mamba2
    layer's new state and conv window (the window cast to the cache's
    dtype) into ``cache`` in place and returns (logits (B, 1, V), the
    cache with ``position + 1``).  Under a mesh, on a DTensor cache, the
    entries are written out of place and the returned cache holds new
    tensors."""
    mamba = _mamba_layers(cfg)
    mesh = on_mesh(cache.kv_k if cache.kv_k is not None
                   else cache.ssm_state)
    new_k, new_v, new_state, new_conv = [], [], [], []
    x = embed_inputs(params, cfg, inputs)
    if mamba:
        kv_index = _attention_layer_index(cfg)
        for layer, block in enumerate(params["blocks"]):
            h, new = ssm_decode_step(
                block["ssm"], cfg, rms_norm(x, block["norm"], cfg.rms_eps),
                SSMCache(state=cache.ssm_state[layer],
                         conv=cache.ssm_conv[layer]))
            if mesh:
                new_state.append(new.state)
                new_conv.append(new.conv.to(cache.ssm_conv.dtype))
            else:
                cache.ssm_state[layer] = new.state
                cache.ssm_conv[layer] = new.conv
            x = _residual(x, h, cfg)
            if _shared_after(cfg, layer):
                x, kv_l = _decode_attention(params["shared"], cfg, x, cache,
                                            kv_index[layer], attention)
                new_k.append(kv_l.k)
                new_v.append(kv_l.v)
    else:
        for layer, block in enumerate(params["blocks"]):
            x, kv_l = _decode_attention(block, cfg, x, cache, layer,
                                        attention)
            new_k.append(kv_l.k)
            new_v.append(kv_l.v)
    if mesh:
        cache = cache._replace(
            **{name: torch.stack(entries)
               for name, entries in (("kv_k", new_k), ("kv_v", new_v),
                                     ("ssm_state", new_state),
                                     ("ssm_conv", new_conv)) if entries})
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), cache._replace(
        position=cache.position + 1)
