"""Shared neural building blocks (port of ``repro.models.layers``).

Parameters are nested dicts of tensors; every function takes the params
subtree it owns, under the reference's names.  Each function rounds where
the reference rounds: statistics and RoPE angles in float32, the result
back in the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_init(generator: torch.Generator, shape, scale: float,
                dtype: torch.dtype, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 from ``generator`` on its
    device (or on ``device``: ``meta`` gives the shape alone), then cast
    to ``dtype``."""
    device = generator.device if device is None else device
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exponents = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)        # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    dtype = x.dtype
    gate = x @ w_gate.to(dtype)
    up = x @ w_up.to(dtype)
    return (F.silu(gate) * up) @ w_down.to(dtype)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, device=None) -> dict:
    scale_in = d_model ** -0.5
    scale_out = d_ff ** -0.5
    return {
        "gate": normal_init(generator, (d_model, d_ff), scale_in, dtype,
                            device),
        "up": normal_init(generator, (d_model, d_ff), scale_in, dtype,
                          device),
        "down": normal_init(generator, (d_ff, d_model), scale_out, dtype,
                            device),
    }


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time with SiLU.  x: (B, L, C); weight:
    (C, W).  Sums in f32 tap by tap, as the reference; returns x's
    dtype."""
    w = weight.shape[-1]
    seq = x.shape[1]
    pad = F.pad(x, (0, 0, w - 1, 0))
    weight = weight.to(torch.float32)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(w):
        out = out + pad[:, i:i + seq, :].to(torch.float32) \
            * weight[:, i][None, None, :]
    return F.silu(out).to(x.dtype)
