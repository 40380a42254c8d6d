"""Kernel 8: the Mamba2 SSD (state-space duality) chunked scan, with its
plain PyTorch twin.

``ssd_scan_cuda`` launches ``ssd_scan`` of ``csrc/ssd_scan.cu`` (built by
:mod:`repro_torch.kernels._build`), which replaces the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas``.  The port's SSM prefill
(:func:`repro_torch.models.ssm.ssm_block`) runs it once per layer.

Layouts are the reference's: x (B, L, H, P) in f32 or bf16, dt (B, L, H)
f32, a (H,) f32 (negative), bm and cm (B, L, N) in x's dtype and shared
by all heads; out y (B, L, H, P) f32 and the final state (B, H, P, N) f32.
Both take an optional f32 initial state (zeros when absent) and any L.
The kernel walks its own sub-chunk length (the function does not depend
on it); the twin takes the caller's ``chunk``, as the TPU kernel does.

A wrapper launches its kernel only for CUDA tensors and raises on what the
kernel does not take; an N whose tiles do not fit a block's shared memory
is refused by the launcher, whose status raises too.  The twin is for
tensors on the CPU, or for a caller that asks for the plain path.  Each
kernel launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from .dissatisfaction import _check, _ptr, _raise_on

# kernel name -> launches since the last reset_launches()
launches = {"ssd_scan": 0}
# twin name -> calls since the last reset_launches(), so a run on the card
# can show that no plain twin took the kernel's place
twin_calls = {"ssd_scan_twin": 0}

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for counts in (launches, twin_calls):
        for name in counts:
            counts[name] = 0


def ssd_scan_twin(x, dt, a, bm, cm, chunk: int, init_state=None):
    """Plain twin of :func:`ssd_scan_cuda`, in the TPU kernel's order of
    operations: L zero-padded to whole chunks, the chunks in order with
    the (B, H, P, N) state carried between them, every head at once."""
    twin_calls["ssd_scan_twin"] += 1
    b, seq, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, seq)
    pad = -seq % q
    f32 = torch.float32
    x = torch.nn.functional.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt.to(f32), (0, 0, 0, pad))
    bm = torch.nn.functional.pad(bm.to(f32), (0, 0, 0, pad))
    cm = torch.nn.functional.pad(cm.to(f32), (0, 0, 0, pad))
    a = a.to(f32)
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for t0 in range(0, seq + pad, q):
        xc = x[:, t0:t0 + q].permute(0, 2, 1, 3)          # (B, H, Q, P)
        dtc = dt[:, t0:t0 + q].permute(0, 2, 1)           # (B, H, Q)
        bc, cc = bm[:, t0:t0 + q], cm[:, t0:t0 + q]       # (B, Q, N)
        cum = torch.cumsum(dtc * a[None, :, None], dim=-1)
        decay = torch.exp(cum[..., :, None] - cum[..., None, :])
        lmat = torch.where(causal, decay, 0.0)            # (B, H, Q, Q)
        cb = (cc @ bc.transpose(-1, -2))[:, None]         # (B, 1, Q, Q)
        scores = cb * lmat * dtc[..., None, :]
        y_diag = scores @ xc
        y_off = (cc[:, None] * torch.exp(cum)[..., None]) \
            @ state.transpose(-1, -2)                     # (B, H, Q, P)
        total = torch.exp(cum[..., -1])
        wts = torch.exp(cum[..., -1:] - cum) * dtc        # (B, H, Q)
        inc = xc.transpose(-1, -2) @ (bc[:, None] * wts[..., None])
        state = state * total[..., None, None] + inc
        ys.append((y_diag + y_off).permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1)[:, :seq], state


def ssd_scan_cuda(x, dt, a, bm, cm, init_state=None):
    """Kernel 8 on the card: (y (B, L, H, P) f32, final state (B, H, P, N)
    f32)."""
    from . import _build
    device = x.device
    if device.type != "cuda":
        raise ValueError("ssd_scan_cuda needs CUDA tensors")
    if x.ndim != 4 or bm.ndim != 3:
        raise ValueError(f"x must be (B, L, H, P) and bm, cm (B, L, N); got "
                         f"{tuple(x.shape)}, {tuple(bm.shape)}")
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"the kernel takes x, bm, cm in float32 or "
                         f"bfloat16; got {x.dtype}")
    b, seq, h, p = x.shape
    n = bm.shape[-1]
    _check("x", x, x.dtype, (b, seq, h, p), device)
    _check("dt", dt, torch.float32, (b, seq, h), device)
    _check("a", a, torch.float32, (h,), device)
    _check("bm", bm, x.dtype, (b, seq, n), device)
    _check("cm", cm, x.dtype, (b, seq, n), device)
    if init_state is not None:
        _check("init_state", init_state, torch.float32, (b, h, p, n), device)
    y = torch.empty((b, seq, h, p), dtype=torch.float32, device=device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=device)
    if seq == 0 or y.numel() == 0 or n == 0:    # nothing to scan
        y.zero_()
        if init_state is None:
            return y, final.zero_()
        return y, final.copy_(init_state)
    lib = _build.library("ssd_scan")
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.ssd_scan(
        _ptr(x), _ptr(dt), _ptr(a), _ptr(bm), _ptr(cm), _ptr(init_state),
        _ptr(y), _ptr(final), b, seq, h, p, n, DTYPE_CODE[x.dtype],
        ctypes.c_void_p(stream))
    _raise_on(status, "ssd_scan")
    launches["ssd_scan"] += 1
    return y, final
