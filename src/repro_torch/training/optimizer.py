"""AdamW and LR schedules (cosine and MiniCPM's WSD), port of
``repro.training.optimizer``.

Plain tensor operations on the port's parameter trees, the reference's
order of operations: global-norm clipping, f32 moments, bias correction,
decoupled weight decay.  ``torch.optim.AdamW`` is not used: it applies
decay and clipping elsewhere.  The schedules are f32 tensors, as the
reference computes them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .tree import flatten, map_tree, unflatten


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def decays(path: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays the parameter at ``path``.  The reference
    decays a leaf of ndim >= 2 (``repro/training/optimizer.py:47``), and
    every leaf under its ``blocks`` carries the stacked layer axis, so
    there its per-layer norms, biases and ``A_log``/``dt_bias``/``D`` are
    decayed too.  The port keeps one dict per layer: under ``blocks`` the
    rule is ndim >= 1, elsewhere ndim >= 2."""
    return p.ndim >= (1 if path.split("/", 1)[0] == "blocks" else 2)


def adamw_init(params, dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    device = flatten(params)[1][0].device
    return AdamWState(mu=map_tree(zeros, params), nu=map_tree(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def adamw_update(grads, state: AdamWState, params, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (new_params, new_state, gnorm); ``gnorm`` is the global
    gradient norm before clipping."""
    f32 = torch.float32
    count = state.count + 1
    _, flat_g = flatten(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                           for g in flat_g))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step_f = count.to(f32)
    c1 = 1 - torch.pow(b1, step_f)
    c2 = 1 - torch.pow(b2, step_f)

    def upd(path, g, m, v, p):
        g = g.to(f32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        if decays(path, p):
            step = step + weight_decay * p.to(f32)
        new_p = p.to(f32) - lr * step
        return new_p.to(p.dtype), m, v

    paths, flat_p = flatten(params)
    out = [upd(*args) for args in zip(paths, flat_g, flatten(state.mu)[1],
                                      flatten(state.nu)[1], flat_p)]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(mu=new_m, nu=new_v, count=count), gnorm


def _f32_step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    step = _f32_step(step)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr: float, warmup: int, stable: int,
                 decay: int, min_ratio: float = 0.01):
    """MiniCPM's Warmup-Stable-Decay: linear warmup, long flat stage, short
    exponential-ish (here linear) decay tail [arXiv:2404.06395]."""
    step = _f32_step(step)
    warm = peak_lr * step / max(warmup, 1)
    in_decay = step > (warmup + stable)
    frac = torch.clamp((step - warmup - stable) / max(decay, 1), 0, 1)
    tail = peak_lr * (1 - (1 - min_ratio) * frac)
    return torch.where(step < warmup, warm,
                       torch.where(in_decay, tail,
                                   torch.full_like(step, peak_lr)))
