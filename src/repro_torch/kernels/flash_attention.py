"""Kernel 7: causal GQA flash-attention forward (the prefill), with its
plain PyTorch twin.

``flash_attention_cuda`` replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas`` and routes by
dtype: bfloat16, the serving path, launches ``flash_attention_bf16`` of
``csrc/flash_attention.cu`` (tensor cores, TMA); float32 launches
``flash_attention`` of ``csrc/attention.cu`` (f32 on the CUDA cores).
Both are built by :mod:`repro_torch.kernels._build`.  The port's prefill
(:func:`repro_torch.models.attention._causal_core`) runs it once per layer.
The kernels never build the S x S logits and take any S unpadded and any
head_dim from 1 to 256: the bf16 kernel reads a head width that is a
multiple of 8 as it is (TMA zero-fills the rest of its 64-column boxes),
and the wrapper pads any other width with zeros to the next multiple of 8
(:func:`_padded_head_dim`), as the reference pads D.

Layouts are the reference's: q and out (B, S, H, D), k and v
(B, S, Hkv, D); query head ``h`` belongs to kv head ``h // G``.

A wrapper launches its kernel only for CUDA tensors and raises on what the
kernel does not take; more than 64 query heads per kv head is refused by
the launchers, whose status raises too.  The twin is for tensors on the
CPU, or for a caller that asks for the plain path.  Each kernel launch
adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

from .decode_attention import MAX_HEAD_DIM, MIN_DENOM, NEG_BIG, _check_common
from .dissatisfaction import _check, _ptr, _raise_on

# kernel name -> launches since the last reset_launches()
launches = {"flash_attention": 0}
# twin name -> calls since the last reset_launches(), so a run on the card
# can show that no plain twin took the kernel's place
twin_calls = {"flash_attention_twin": 0}


def reset_launches() -> None:
    for counts in (launches, twin_calls):
        for name in counts:
            counts[name] = 0


def flash_attention_twin(q, k, v) -> torch.Tensor:
    """Plain twin of :func:`flash_attention_cuda`: f32 over the full S x S
    logits, with the kernel's pre-scaled q, finite mask and clamp."""
    twin_calls["flash_attention_twin"] += 1
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.to(torch.float32).reshape(b, s, hkv, h // hkv, d) \
        * (1.0 / d ** 0.5)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=q.device))
    logits = torch.where(causal, logits, NEG_BIG)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=MIN_DENOM)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / denom, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def _padded_head_dim(d: int) -> int:
    """The head width the bf16 kernel reads for head_dim ``d``: the next
    multiple of 8 (its tensor maps need rows of whole 16-byte vectors)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim in [1, {MAX_HEAD_DIM}]; "
                         f"got {d}")
    return -(-d // 8) * 8


def flash_attention_cuda(q, k, v) -> torch.Tensor:
    """Kernel 7 on the card: (B, S, H, D) causal attention output."""
    from . import _build
    device = q.device
    if device.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, S, Hkv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    _check("q", q, q.dtype, (b, s, h, d), device)
    _check("k", k, q.dtype, (b, s, hkv, d), device)
    _check("v", v, q.dtype, (b, s, hkv, d), device)
    _check_common(q, k, v, d)
    if b == 0 or s == 0 or h == 0:
        return torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    if q.dtype == torch.float32:
        out = torch.empty_like(q)
        status = _build.library("attention").flash_attention(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), b, s, h, hkv, d, stream)
    else:
        width = _padded_head_dim(d)
        if width != d:
            q, k, v = (nnf.pad(t, (0, width - d)) for t in (q, k, v))
        out = torch.empty_like(q)
        status = _build.library("flash_attention").flash_attention_bf16(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), b, s, h, hkv, width, d,
            stream)
        out = out[..., :d].contiguous() if width != d else out
    _raise_on(status, "flash_attention")
    launches["flash_attention"] += 1
    return out
