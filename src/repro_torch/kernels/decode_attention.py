"""Kernel 6: one-token GQA decode attention over a KV cache, with its plain
PyTorch twin.

``decode_attention_cuda`` launches ``decode_attention`` of
``csrc/decode_attention.cu`` (built by :mod:`repro_torch.kernels._build`),
which replaces the TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``.  The port's
decode step (:func:`repro_torch.models.attention.decode_attention_step`)
runs it once per layer.

Layouts are the reference's: q (B, H, D), k and v (B, S, Hkv, D), length
(B,) int32, out (B, H, D) in q's dtype; query head ``h`` belongs to kv
head ``h // G`` with ``G = H // Hkv``.  Lengths are clamped to [0, S]; a
row with no valid key gives zeros.

The kernel splits S: :func:`split_size` sets the positions per split from
S, B * Hkv and the card's SM count, never from ``length``, so the call
adds no host sync.  With more than one split each live split writes f32
partials to scratch allocated here, and the last split of a (row, kv
head) to finish combines them in split order, found by an integer ticket
in a per-device buffer of zeros (:func:`_tickets`) that every launch
leaves at zero; calls on one device must not run concurrently on two
streams.  The result is bitwise the same from run to run.

Any head_dim from 1 to 256 is taken: the kernel is built for a padded
width (16, 32, 64, 128 or 256); a head_dim that is not a multiple of 8
takes the kernel's instance that stages its tiles with plain loads
instead of TMA.

A wrapper launches its kernel only for CUDA tensors and raises on what the
kernel does not take; a group of G = H // Hkv query heads too large for
one block's shared memory is refused by the launcher, whose status raises
too.  The twin is for tensors on the CPU, or for a caller that asks for
the plain path.  Each kernel launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .dissatisfaction import _check, _ptr, _raise_on

# kernel name -> launches since the last reset_launches()
launches = {"decode_attention": 0}
# twin name -> calls since the last reset_launches(), so a run on the card
# can show that no plain twin took the kernel's place
twin_calls = {"decode_attention_twin": 0}

MAX_HEAD_DIM = 256               # widest head the kernels 6-7 take
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NEG_BIG = -1.0e30                # the TPU kernels' finite mask
MIN_DENOM = 1e-30                # their clamp of the softmax divisor
# constants of csrc/decode_attention.cu
TILE = 64                        # kTile: positions per K/V tile
STAGES = 2                       # kStages: K/V tiles in flight
MAX_SPLITS = 32                  # kMaxSplits: splits of S at most
# the split chooser: a split holds at least MIN_SPLIT positions and grows
# (doubling from TILE) until B * Hkv * splits, every row taken as full,
# is at most SPLIT_BLOCKS_PER_SM blocks for each SM
MIN_SPLIT = 128
SPLIT_BLOCKS_PER_SM = 20


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
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim in [1, {MAX_HEAD_DIM}]; "
                         f"got {head_dim}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def split_size(s: int, rows: int, sms: int) -> int:
    """Positions per split of kernel 6 for a cache of ``s`` positions,
    ``rows`` = B * Hkv (row, kv head) pairs and ``sms`` SMs: a power-of-two
    multiple of :data:`TILE`, at least :data:`MIN_SPLIT` and ``s /
    MAX_SPLITS``, doubled while ``rows`` full rows would make more than
    ``SPLIT_BLOCKS_PER_SM * sms`` blocks, and never past the first that
    covers ``s``."""
    split = TILE
    while split < s and (split < MIN_SPLIT or split * MAX_SPLITS < s
                         or rows * -(-s // split)
                         > SPLIT_BLOCKS_PER_SM * sms):
        split *= 2
    return split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_ticket_buffers: dict[int, torch.Tensor] = {}


def _tickets(device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, one per (row, kv head),
    kept across calls: each launch leaves them at zero."""
    buf = _ticket_buffers.get(device.index)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel()) if buf is not None else n
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _ticket_buffers[device.index] = buf
    return buf


def decode_attention_args(q, k, v, length, out, split: int | None = None):
    """The C entry point's arguments for one launch of kernel 6 on checked
    CUDA tensors, and the scratch they point into (keep it alive until the
    launch has run).  ``split`` defaults to :func:`split_size`'s."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if split is None:
        split = split_size(s, b * hkv, _sm_count(q.device.index))
    n_split = -(-s // split)
    partial = ticket = None
    if n_split > 1:
        partial = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                              device=q.device)
        ticket = _tickets(q.device, b * hkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(length), _ptr(out),
            _ptr(partial), _ptr(ticket), b, h, hkv, s, d, split,
            DTYPE_CODE[q.dtype],
            ctypes.c_void_p(stream))
    return args, (partial, ticket)


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
    if s == 0:
        return out.zero_()
    args, _scratch = decode_attention_args(q, k, v, length, out)
    status = _build.library("decode_attention").decode_attention(*args)
    _raise_on(status, "decode_attention")
    launches["decode_attention"] += 1
    return out
