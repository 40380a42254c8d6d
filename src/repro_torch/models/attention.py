"""GQA attention: causal full-sequence (prefill) and cached decode (port of
``repro.models.attention``).

Both paths run the port's kernels: the prefill's causal core is kernel 7
(:func:`repro_torch.kernels.ops.flash_attention`), the decode step's
attention kernel 6 (:func:`repro_torch.kernels.ops.decode_attention`).
On CPU tensors those adapters take the kernels' plain twins; pass
``attention="plain"`` to take the twins on the card too.  Under autograd
(an input of the core requires a gradient) the core runs kernel 7
through :class:`_FlashAttention`, whose backward recomputes the
reference's formula (:func:`_causal_core_plain`) with plain PyTorch
operations: no backward kernel, no twin.  The kernels keep
the probabilities in f32 where the reference rounds them to the compute
dtype before P·V, so the two agree to float rounding at f32 compute and
to bf16 rounding at bf16.

The reference's sharding hints (``sharding.hints.hint``) stand at their
sites: the sequence-parallel layout of q, k and v in
:func:`_causal_core` and of its output, and, moved before the
(heads, head_dim) split, on the flat projections in :func:`_project_qkv`
(see there).  With no mesh active they return their input, so a path on
one card runs the ops it ran before.  Under a mesh (the dry run) the
decode step writes the cache row out of place (see
:func:`decode_attention_step`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.problem import resolve_device
from ..kernels import ops
from ..kernels.decode_attention import decode_attention_twin
from ..kernels.flash_attention import flash_attention_twin
from ..sharding.hints import DP, hint, on_mesh, relayout
from .config import ModelConfig
from .layers import apply_rope, normal_init

ATTENTION_PATHS = ("kernel", "plain")


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, Hkv, D)
    v: torch.Tensor       # (B, S_max, Hkv, D)
    length: torch.Tensor  # () or (B,) int32 — tokens currently cached


def _check_path(attention: str) -> None:
    if attention not in ATTENTION_PATHS:
        raise ValueError(f"attention must be one of {ATTENTION_PATHS}; got "
                         f"{attention!r}")


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    """Drawn from ``generator`` on its device, or on ``device``."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = d ** -0.5
    dtype = cfg.pdtype()
    dev = generator.device if device is None else device
    params = {
        "wq": normal_init(generator, (d, h * hd), scale, dtype, dev),
        "wk": normal_init(generator, (d, hkv * hd), scale, dtype, dev),
        "wv": normal_init(generator, (d, hkv * hd), scale, dtype, dev),
        "wo": normal_init(generator, (h * hd, d), (h * hd) ** -0.5, dtype,
                          dev),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            params[name] = torch.zeros((width,), dtype=dtype, device=dev)
    return params


def _project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """q (B, S, H, D) and k, v (B, S, Hkv, D) of ``x`` at ``positions``.

    Moved hints: the reference hints q's sequence over 'model' and k, v
    replicated over it after the (heads, head_dim) split, in
    ``_causal_core``; DTensor cannot split a feature dim sharded over
    heads that do not divide the axis (yi-34b: 56 heads on 16), so the
    same dims are hinted here on the flat projections, before the split,
    which then yields the reference's layout.  A decode step's sequence
    of one does not divide the axis, so there q replicates its features
    as k and v do."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype = x.dtype
    q = x @ params["wq"].to(dtype)
    k = x @ params["wk"].to(dtype)
    v = x @ params["wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    q = hint(q, DP, "model", None)
    k = hint(k, DP, None, None)
    v = hint(v, DP, None, None)
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, hkv, hd)


def _causal_core_plain(q, k, v) -> torch.Tensor:
    """The reference's causal core (``repro/models/attention.py:79-114``,
    one query block) in plain PyTorch, its probabilities kept in f32 as
    kernel 7 keeps them: the function whose gradient the training path
    takes.  Builds the S x S logits."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    logits = torch.einsum("bqhgd,bkhd->bhgqk",
                          q.to(torch.float32).reshape(b, s, hkv, h // hkv, d),
                          k.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    logits = torch.where(pos[:, None] >= pos[None, :], logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """Kernel 7 in a differentiable graph: the forward is the prefill's
    adapter (``ops.flash_attention``: the kernel on the card, its twin on
    CPU tensors); the backward takes the gradient of
    :func:`_causal_core_plain` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return ops.flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _causal_core_plain(*inputs)
        return torch.autograd.grad(out, inputs, grad)


def _causal_core(q, k, v, cfg: ModelConfig, q_chunks: int | None = None,
                 attention: str = "kernel") -> torch.Tensor:
    """Causal softmax attention.  q: (B,S,H,D), k/v: (B,S,Hkv,D) ->
    (B,S,H,D), on kernel 7.  ``q_chunks`` (the reference's XLA-level
    blocking) is accepted and has no effect: the kernel never builds the
    S x S logits, so the reference's hint on its query blocks has no site
    here.

    The reference's sequence-parallel hints: q's sequence over 'model',
    k and v replicated over it, and the output's sequence over 'model'
    (the reference hints it on its (B, S, Hkv, G, D) form; the kernel
    returns (B, S, H, D)).  The reference also hints the logits' query
    dim over 'model'; the port's logits exist only inside the kernel and
    its twin, where q's layout already puts them there."""
    del cfg, q_chunks
    _check_path(attention)
    q = hint(q, DP, "model", None, None)
    k = hint(k, DP, None, None, None)
    v = hint(v, DP, None, None, None)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if attention == "plain":
        out = flash_attention_twin(q, k, v)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out = _FlashAttention.apply(q, k, v)
    else:
        out = ops.flash_attention(q, k, v)
    return hint(out, DP, "model", None, None)


def _project_out(params: dict, out: torch.Tensor, dtype) -> torch.Tensor:
    """The core's (B, S, H, D) output through ``wo``.  Under a mesh its
    sequence is gathered first, as ``transformer._norm`` gathers a
    matmul's input."""
    b, s = out.shape[0], out.shape[1]
    return relayout(out.reshape(b, s, -1), DP, None, None) \
        @ params["wo"].to(dtype)


def causal_attention(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     attention: str = "kernel") -> torch.Tensor:
    """Full causal self-attention for prefill.  x: (B, S, d)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = _causal_core(q, k, v, cfg, attention=attention)
    return _project_out(params, out, x.dtype)


def _per_head_shard(fn, k):
    """``fn`` (decode attention on q, k, v, length) run on each rank's
    own heads where the cache ``k`` (a DTensor) shards its heads, else
    ``fn``.  Decode attention is independent per head, so each shard's
    heads attend locally, as the reference's partitioned decode does;
    DTensor's own propagation would gather the cache to merge the
    (batch, heads) dims of its batched product."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    kv = tuple(k.placements)
    if Shard(2) not in kv:
        return fn
    q = tuple(Shard(1) if p == Shard(2) else p for p in kv)
    rows = tuple(p if p == Shard(0) else Replicate() for p in kv)
    return local_map(fn, out_placements=list(q),
                     in_placements=(list(q), list(kv), list(kv), list(rows)),
                     device_mesh=k.device_mesh, redistribute_inputs=True)


def decode_attention_step(params: dict, cfg: ModelConfig, x: torch.Tensor,
                          cache: KVCache, attention: str = "kernel"):
    """One-token decode.  x: (B, 1, d); returns (B, 1, d) and the cache
    with ``length + 1``.  The new key and value are written into
    ``cache.k``/``cache.v`` IN PLACE, at row ``min(length, S - 1)``: XLA's
    ``dynamic_update_slice`` clamps the reference's write the same way, so
    a slot whose position ran past the cache overwrites its last row and
    attends over all S rows.  Under a mesh, on a DTensor cache, the row is
    written out of place (a ``torch.where`` on the row's position that
    each shard applies to its own rows, as the reference's update slice
    is partitioned) and the returned cache holds the new tensors; on a
    cache sharded over heads the attention runs on each shard's heads
    (:func:`_per_head_shard`)."""
    _check_path(attention)
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    s = cache.k.shape[1]
    length = torch.broadcast_to(cache.length, (b,))
    q, k_new, v_new = _project_qkv(params, cfg, x, length[:, None])

    idx = torch.clamp(length, max=s - 1).long()
    if on_mesh(cache.k):
        at = (torch.arange(s, device=x.device)[None, :]
              == idx[:, None])[:, :, None, None]
        k_all = torch.where(at, k_new.to(cache.k.dtype), cache.k)
        v_all = torch.where(at, v_new.to(cache.v.dtype), cache.v)
    else:
        rows = torch.arange(b, device=x.device)
        cache.k[rows, idx] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, idx] = v_new[:, 0].to(cache.v.dtype)
        k_all, v_all = cache.k, cache.v
    new_len = cache.length + 1

    fn = ops.decode_attention if attention == "kernel" \
        else decode_attention_twin
    if on_mesh(k_all):
        fn = _per_head_shard(fn, k_all)
    out = fn(q.reshape(b, h, hd).to(k_all.dtype), k_all, v_all,
             torch.broadcast_to(new_len, (b,)).to(torch.int32).contiguous())
    out = out.to(x.dtype).reshape(b, 1, h * hd)
    out = out @ params["wo"].to(x.dtype)
    return out, KVCache(k=k_all, v=v_all, length=new_len)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """An empty one-layer cache on ``device`` (default: the card)."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )
