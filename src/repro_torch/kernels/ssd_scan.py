"""Kernel 8: the Mamba2 SSD (state-space duality) chunked scan, with its
plain PyTorch twin.

``ssd_scan_cuda`` replaces the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas`` and routes by dtype: bfloat16
x/bm/cm, the serving path, launch ``ssd_scan_bf16`` of
``csrc/ssd_scan_bf16.cu`` (three chunk-parallel passes on the tensor cores,
TMA); float32 launches ``ssd_scan`` of ``csrc/ssd_scan.cu`` (f32 on the
CUDA cores).  Both are built by :mod:`repro_torch.kernels._build`.  The
port's SSM prefill (:func:`repro_torch.models.ssm.ssm_block`) runs it once
per layer.

Layouts are the reference's: x (B, L, H, P) in f32 or bf16, dt (B, L, H)
f32, a (H,) f32 (negative), bm and cm (B, L, N) in x's dtype and shared
by all heads; out y (B, L, H, P) f32 and the final state (B, H, P, N) f32.
Both take an optional f32 initial state (zeros when absent) and any L.
The kernels walk their own chunk lengths (the function does not depend on
it); the twin takes the caller's ``chunk``, as the TPU kernel does.  The
bf16 kernel reads P and N that are multiples of 8 as they are; the wrapper
pads other widths with zeros to the next multiple of 8
(:func:`_padded_widths`) and refuses P > 64 or N > 256.

A wrapper launches its kernel only for CUDA tensors and raises on what the
kernel does not take; an N whose tiles do not fit a block's shared memory
is refused by the f32 launcher, whose status raises too.  The twin is for
tensors on the CPU, or for a caller that asks for the plain path.  Each
wrapper call that launches adds one to :data:`launches`, whatever the
number of device launches inside (:data:`DEVICE_LAUNCHES`).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as nnf

from .dissatisfaction import _check, _ptr, _raise_on

# kernel name -> launches since the last reset_launches()
launches = {"ssd_scan": 0}
# twin name -> calls since the last reset_launches(), so a run on the card
# can show that no plain twin took the kernel's place
twin_calls = {"ssd_scan_twin": 0}

# device launches per wrapper call, by the dtype of x: the bf16 kernel's
# three passes (chunk states, state passing, chunk outputs), the f32 one
DEVICE_LAUNCHES = {torch.bfloat16: 3, torch.float32: 1}
# the bf16 kernel's widest P and N (csrc/ssd_scan_bf16.cu: kMaxP, kMaxN)
BF16_MAX_P = 64
BF16_MAX_N = 256


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
        # masked before the exp: the same values as where(causal,
        # exp(.), 0), and no inf above the diagonal for autograd to meet
        lmat = torch.exp(torch.where(
            causal, cum[..., :, None] - cum[..., None, :], -math.inf))
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


def _padded_widths(p: int, n: int) -> tuple[int, int]:
    """The (P, N) the bf16 kernel reads for a head width ``p`` and a state
    width ``n``: the next multiples of 8 (its tensor maps need rows of
    whole 16-byte vectors)."""
    if not (1 <= p <= BF16_MAX_P and 1 <= n <= BF16_MAX_N):
        raise ValueError(f"the bf16 kernel takes P in [1, {BF16_MAX_P}] and "
                         f"N in [1, {BF16_MAX_N}]; got P={p}, N={n}")
    return -(-p // 8) * 8, -(-n // 8) * 8


def _pad_widths(x, bm, cm, init_state, pw: int, nw: int):
    """x, bm, cm and the initial state with zeros appended to P (to ``pw``)
    and N (to ``nw``): the zero rows of the state and columns of B and C
    add nothing to y or to the state's first P x N block."""
    p, n = x.shape[-1], bm.shape[-1]
    if (pw, nw) == (p, n):
        return x, bm, cm, init_state
    if init_state is not None:
        init_state = nnf.pad(init_state, (0, nw - n, 0, pw - p))
    return (nnf.pad(x, (0, pw - p)), nnf.pad(bm, (0, nw - n)),
            nnf.pad(cm, (0, nw - n)), init_state)


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
    if x.dtype not in DEVICE_LAUNCHES:
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
    if seq == 0 or x.numel() == 0 or n == 0:    # nothing to scan
        y = torch.zeros((b, seq, h, p), dtype=torch.float32, device=device)
        if init_state is None:
            return y, torch.zeros((b, h, p, n), dtype=torch.float32,
                                  device=device)
        return y, init_state.clone()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    if x.dtype == torch.bfloat16:
        pw, nw = _padded_widths(p, n)
        lib = _build.library("ssd_scan_bf16")
        x, bm, cm, init_state = _pad_widths(x, bm, cm, init_state, pw, nw)
        y = torch.empty((b, seq, h, pw), dtype=torch.float32, device=device)
        final = torch.empty((b, h, pw, nw), dtype=torch.float32,
                            device=device)
        work = torch.empty(lib.ssd_scan_bf16_work_bytes(b, seq, h, pw, nw),
                           dtype=torch.uint8, device=device)
        status = lib.ssd_scan_bf16(
            _ptr(x), _ptr(dt), _ptr(a), _ptr(bm), _ptr(cm),
            _ptr(init_state), _ptr(y), _ptr(final), _ptr(work), b, seq, h,
            pw, nw, stream)
        if (pw, nw) != (p, n):
            y = y[..., :p].contiguous()
            final = final[:, :, :p, :n].contiguous()
    else:
        y = torch.empty((b, seq, h, p), dtype=torch.float32, device=device)
        final = torch.empty((b, h, p, n), dtype=torch.float32,
                            device=device)
        status = _build.library("ssd_scan").ssd_scan(
            _ptr(x), _ptr(dt), _ptr(a), _ptr(bm), _ptr(cm),
            _ptr(init_state), _ptr(y), _ptr(final), b, seq, h, p, n, stream)
    _raise_on(status, "ssd_scan")
    launches["ssd_scan"] += 1
    return y, final
