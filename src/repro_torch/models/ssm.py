"""Mamba2 (state-space duality) block (port of ``repro.models.ssm``): the
chunked SSD scan for prefill and a constant-memory recurrent step for
decode.

``ssm_block`` sends its scan through kernel 8
(:func:`repro_torch.kernels.ops.ssd_scan`); on CPU tensors that adapter
takes the kernel's plain twin, and ``ssm="plain"`` takes the twin on the
card too.  Under autograd (an input of the scan requires a gradient) the
scan runs kernel 8 through :class:`_SSDScan`, whose backward recomputes
``ssd_chunked`` with plain PyTorch operations: no backward kernel, no
twin.  ``ssd_chunked`` is the reference's own jnp formulation, ported
as it is: the tests' oracle.  ``ssm_decode_step`` is plain PyTorch (one
rank-1 state update per head; the reference has no decode kernel).

Tensor conventions (the reference's):
  x   (B, L, H, P)  — H ssm heads of head_dim P (d_inner = H*P)
  dt  (B, L, H)     — softplus-positive step sizes, f32
  A   (H,)          — negative per-head decay rates, f32
  Bm/Cm (B, L, N)   — single-group input/output projections (n_groups = 1)
State: (B, H, P, N) f32.  Every decay exponent is <= 0, so every exp() is
bounded by 1.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.problem import resolve_device
from ..kernels import ops
from ..kernels.ssd_scan import ssd_scan_twin
from .config import ModelConfig
from .layers import causal_conv1d, normal_init, rms_norm

SSM_PATHS = ("kernel", "plain")


class SSMCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) f32
    conv: torch.Tensor    # (B, W-1, conv_dim) — rolling conv window


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_ssm(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> dict:
    """The reference's initializers and scales, drawn from ``generator``
    on its device (or on ``device``): ``A_log``, ``dt_bias`` and ``D`` in
    f32, the rest in the parameter dtype."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * n + h     # z, x, B, C, dt
    dtype = cfg.pdtype()
    dev = generator.device if device is None else device
    f32 = torch.float32
    in_proj = normal_init(generator, (d, proj_out), d ** -0.5, dtype, dev)
    conv_w = normal_init(generator, (conv_dim(cfg), cfg.ssm_conv),
                         cfg.ssm_conv ** -0.5, dtype, dev)
    a_log = torch.log(1.0 + 15.0 * torch.rand(
        (h,), generator=generator, dtype=f32, device=dev))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(
        (h,), generator=generator, dtype=f32, device=dev))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "A_log": a_log,
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "D": torch.ones((h,), dtype=f32, device=dev),
        "gate_norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal_init(generator, (di, d), di ** -0.5, dtype,
                                dev),
    }


def _split_proj(params: dict, cfg: ModelConfig, u: torch.Tensor):
    """in_proj + causal conv.  u: (B, L, d) -> (z, x, Bm, Cm, dt,
    xbc_pre)."""
    di, n = cfg.d_inner, cfg.ssm_state
    proj = u @ params["in_proj"].to(u.dtype)
    z = proj[..., :di]
    xbc_pre = proj[..., di:di + di + 2 * n]
    dt_raw = proj[..., di + di + 2 * n:]
    xbc = causal_conv1d(xbc_pre, params["conv_w"])
    x = xbc[..., :di]
    bm = xbc[..., di:di + n]
    cm = xbc[..., di + n:]
    dt = F.softplus(dt_raw.to(torch.float32)
                    + params["dt_bias"][None, None, :])
    # xbc_pre's last (W-1) rows are the rolling conv window that
    # ssm_decode_step keeps in SSMCache.conv
    return z, x, bm, cm, dt, xbc_pre


def ssd_chunked(x, dt, a, bm, cm, chunk: int, init_state=None):
    """The reference's chunked SSD scan in its own formulation (all
    chunks' diagonal blocks at once, then the inter-chunk recurrence).
    Returns (y (B, L, H, P) f32, final_state (B, H, P, N) f32); any L,
    zero-padded to a chunk multiple (dt = 0 leaves the state as it is)."""
    b, seq, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, seq)
    pad = -seq % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = (seq + pad) // q
    f32 = torch.float32

    xf = x.to(f32).reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bmc = bm.to(f32).reshape(b, nc, q, n)
    cmc = cm.to(f32).reshape(b, nc, q, n)

    da = dtc * a[None, None, None, :]                       # (B,nc,Q,H) <= 0
    cum = torch.cumsum(da, dim=2)                           # inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Qi,Qj,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    # the reference's where(causal, exp(seg), 0), with the mask applied
    # before the exp: the same values, but the masked exponents (positive,
    # past exp's range at real decays) no longer meet a zero cotangent as
    # inf, which made the gradient NaN
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  -math.inf))

    cb = torch.einsum("bcin,bcjn->bcij", cmc, bmc)          # (B,nc,Q,Q)
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    # per-chunk end states: sum_j exp(cum_Q - cum_j) * dt_j * B_j ⊗ x_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,H)
    wts = decay_end * dtc
    chunk_states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", wts, bmc, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)

    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    prev = []
    for c in range(nc):                                     # state *before*
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cmc, prev_states,
                         torch.exp(cum))
    y = (y_diag + y_off).reshape(b, nc * q, h, p)
    return y[:, :seq], state


def _check_path(ssm: str) -> None:
    if ssm not in SSM_PATHS:
        raise ValueError(f"ssm must be one of {SSM_PATHS}; got {ssm!r}")


class _SSDScan(torch.autograd.Function):
    """Kernel 8 in a differentiable graph: the forward is the prefill's
    adapter (``ops.ssd_scan``: the kernel on the card, its twin on CPU
    tensors); the backward takes the gradient of :func:`ssd_chunked`, the
    reference's formulation, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, chunk, init_state):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, bm, cm, init_state)
        return ops.ssd_scan(x, dt, a, bm, cm, chunk, init_state)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        saved = [None if t is None else t.detach().requires_grad_(True)
                 for t in ctx.saved_tensors]
        x, dt, a, bm, cm, init_state = saved
        with torch.enable_grad():
            out = ssd_chunked(x, dt, a, bm, cm, ctx.chunk, init_state)
        live = [t for t in saved if t is not None]
        grads = iter(torch.autograd.grad(out, live, (grad_y, grad_state),
                                         allow_unused=True))
        x, dt, a, bm, cm, init_state = (None if t is None else next(grads)
                                        for t in saved)
        return x, dt, a, bm, cm, None, init_state


def _scan(xh, dt, a, bm, cm, cfg: ModelConfig, init_state, ssm: str):
    """The SSD scan of ``ssm_block`` on kernel 8 (differentiable when an
    input requires a gradient), or its twin for ``ssm="plain"``."""
    args = (xh, dt.contiguous(), a, bm.contiguous(), cm.contiguous())
    if ssm == "plain":
        return ssd_scan_twin(*args, cfg.ssm_chunk, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args + (init_state,)):
        return _SSDScan.apply(*args, cfg.ssm_chunk, init_state)
    return ops.ssd_scan(*args, cfg.ssm_chunk, init_state)


def ssm_block(params: dict, cfg: ModelConfig, u: torch.Tensor,
              init_state=None, *, return_conv_tail: bool = False,
              ssm: str = "kernel"):
    """Full Mamba2 block (prefill).  u: (B, L, d) -> (B, L, d) and the
    final (B, H, P, N) f32 state; the scan runs on kernel 8 (its twin for
    ``ssm="plain"``).  With ``return_conv_tail``, also returns the
    (B, W-1, conv_dim) rolling conv window so decode continues exactly
    where prefill stopped."""
    _check_path(ssm)
    b, seq, _ = u.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    z, x, bm, cm, dt, xbc_pre = _split_proj(params, cfg, u)
    a = -torch.exp(params["A_log"])
    xh = x.reshape(b, seq, h, p).contiguous()
    y, final = _scan(xh, dt, a, bm, cm, cfg, init_state, ssm)
    y = y + params["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(b, seq, cfg.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.rms_eps)
    out = y @ params["out_proj"].to(u.dtype)
    if return_conv_tail:
        w = cfg.ssm_conv
        tail = F.pad(xbc_pre, (0, 0, w - 1, 0))[:, -(w - 1):]
        return out, final, tail
    return out, final


def ssm_decode_step(params: dict, cfg: ModelConfig, u: torch.Tensor,
                    cache: SSMCache):
    """One-token recurrent step.  u: (B, 1, d) -> (B, 1, d) and a new
    cache (``cache`` is not modified)."""
    b = u.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    proj = u @ params["in_proj"].to(u.dtype)
    z = proj[..., :di]
    xbc_new = proj[..., di:di + di + 2 * n]
    dt_raw = proj[..., di + di + 2 * n:]

    # rolling causal conv window
    window = torch.cat([cache.conv, xbc_new], dim=1)        # (B, W, conv)
    conv_out = torch.einsum("bwc,cw->bc", window.to(f32),
                            params["conv_w"].to(f32))
    xbc = F.silu(conv_out)[:, None, :].to(u.dtype)          # (B, 1, conv)
    new_conv = window[:, 1:, :]

    x = xbc[..., :di].reshape(b, h, p).to(f32)
    bm = xbc[..., di:di + n].reshape(b, n).to(f32)
    cm = xbc[..., di + n:].reshape(b, n).to(f32)
    dt = F.softplus(dt_raw[:, 0].to(f32) + params["dt_bias"][None, :])
    a = -torch.exp(params["A_log"])

    decay = torch.exp(dt * a[None, :])                      # (B, H)
    state = cache.state * decay[:, :, None, None] \
        + (dt[:, :, None] * x)[..., None] * bm[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cm, state)
    y = y + params["D"][None, :, None] * x
    y = y.reshape(b, 1, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.rms_eps)
    out = y @ params["out_proj"].to(u.dtype)
    return out, SSMCache(state=state, conv=new_conv)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMCache:
    """An empty cache on ``device`` (default: the card): the state in f32,
    the conv window in ``dtype``."""
    device = resolve_device(device)
    return SSMCache(
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                         dtype=dtype, device=device))
