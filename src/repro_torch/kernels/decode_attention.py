"""Kernel 6: one-token GQA decode attention over a KV cache, with its plain
PyTorch twin.

``decode_attention_cuda`` launches ``decode_attention`` of
``csrc/attention.cu`` (built by :mod:`repro_torch.kernels._build`), which
replaces the TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``.  The port's
decode step (:func:`repro_torch.models.attention.decode_attention_step`)
runs it once per layer.

Layouts are the reference's: q (B, H, D), k and v (B, S, Hkv, D), length
(B,) int32, out (B, H, D) in q's dtype; query head ``h`` belongs to kv
head ``h // G`` with ``G = H // Hkv``.  Lengths are clamped to [0, S]; a
row with no valid key gives zeros.

A wrapper launches its kernel only for CUDA tensors and raises on what the
kernel does not take; a group of G = H // Hkv query heads too large for
one block's shared memory is refused by the launcher, whose status raises
too.  The twin is for tensors on the CPU, or for a caller that asks for
the plain path.  Each kernel launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from .dissatisfaction import _check, _ptr, _raise_on

# kernel name -> launches since the last reset_launches()
launches = {"decode_attention": 0}
# twin name -> calls since the last reset_launches(), so a run on the card
# can show that no plain twin took the kernel's place
twin_calls = {"decode_attention_twin": 0}

HEAD_DIMS = (8, 16, 64, 128)     # head dims the kernels are built for
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NEG_BIG = -1.0e30                # the TPU kernels' finite mask
MIN_DENOM = 1e-30                # their clamp of the softmax divisor


def reset_launches() -> None:
    for counts in (launches, twin_calls):
        for name in counts:
            counts[name] = 0


def decode_attention_twin(q, k, v, length) -> torch.Tensor:
    """Plain twin of :func:`decode_attention_cuda`: f32 over the full
    logits, with the kernel's pre-scaled q, finite mask and clamp."""
    twin_calls["decode_attention_twin"] += 1
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, h // hkv, d) * (1.0 / d ** 0.5)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32))
    length = torch.as_tensor(length, device=q.device).clamp(0, s)
    valid = torch.arange(s, device=q.device)[None, None, None, :] \
        < length[:, None, None, None]
    logits = torch.where(valid, logits, NEG_BIG)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    denom = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=MIN_DENOM)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32)) / denom
    return out.reshape(b, h, d).to(q.dtype)


def _check_common(q, k, v, head_dim: int) -> None:
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16; got "
                         f"{q.dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}; got "
                         f"{head_dim}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention_cuda(q, k, v, length) -> torch.Tensor:
    """Kernel 6 on the card: (B, H, D) attention output of one query token
    per row against the first ``length[b]`` cached keys and values."""
    from . import _build
    device = q.device
    if device.type != "cuda":
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be (B, H, D) and k, v (B, S, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    _check("q", q, q.dtype, (b, h, d), device)
    _check("k", k, q.dtype, (b, s, hkv, d), device)
    _check("v", v, q.dtype, (b, s, hkv, d), device)
    _check("length", length, torch.int32, (b,), device)
    _check_common(q, k, v, d)
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    lib = _build.library("attention")
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.decode_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(length), _ptr(out), b, h, hkv, s, d,
        DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    _raise_on(status, "decode_attention")
    launches["decode_attention"] += 1
    return out
