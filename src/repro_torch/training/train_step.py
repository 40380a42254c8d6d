"""Train step: loss -> grad -> AdamW, with microbatching and the router
statistics the planner reads (port of ``repro.training.train_step``).

Gradients come from ``torch.autograd`` through ``forward_train``: the
forward runs the port's kernels (7 in every attention layer, 8 in every
Mamba2 layer), whose backward recomputes the plain formula
(:mod:`repro_torch.models.attention`, :mod:`repro_torch.models.ssm`).
Microbatching (gradient accumulation) is a loop over microbatch slices in
the reference's order: the first slice, then the others added, then the
sums times ``1/m``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import forward_train, init_params
from . import optimizer as opt
from .tree import flatten, map_tree, unflatten


class TrainState(NamedTuple):
    params: dict
    opt: opt.AdamWState
    step: torch.Tensor
    # cumulative router stats fed to the game-theoretic expert planner
    expert_load: torch.Tensor      # (E,) or (1,)
    coactivation: torch.Tensor     # (E, E) or (1, 1)


def init_train_state(cfg: ModelConfig, generator: torch.Generator | int = 0,
                     device=None) -> TrainState:
    """Parameters from ``generator`` (an int seeds one on ``device``,
    default the card), zero moments and statistics beside them."""
    params = init_params(cfg, generator, device=device)
    dev = params["embed"].device
    e = max(cfg.num_experts, 1)
    f32 = torch.float32
    return TrainState(
        params=params,
        opt=opt.adamw_init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        expert_load=torch.zeros((e,), dtype=f32, device=dev),
        coactivation=torch.zeros((e, e), dtype=f32, device=dev),
    )


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # cosine | wsd
    wsd_stable: int = 700
    wsd_decay: int = 200
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1             # gradient accumulation factor


def _lr(hyper: TrainHyper, step):
    if hyper.schedule == "wsd":
        return opt.wsd_schedule(step, peak_lr=hyper.peak_lr,
                                warmup=hyper.warmup, stable=hyper.wsd_stable,
                                decay=hyper.wsd_decay)
    return opt.cosine_schedule(step, peak_lr=hyper.peak_lr,
                               warmup=hyper.warmup, total=hyper.total_steps)


def value_and_grad(params, cfg: ModelConfig, batch: dict, *,
                   attention: str = "kernel", ssm: str = "kernel"):
    """(loss, metrics, grads) of ``forward_train`` at ``params``; a
    parameter the loss does not read gets a zero gradient, as under
    ``jax.value_and_grad``."""
    _, leaves = flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = forward_train(unflatten(params, live), cfg, batch,
                                  attention=attention, ssm=ssm)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def make_train_step(cfg: ModelConfig, hyper: TrainHyper) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""

    def single(params, batch):
        return value_and_grad(params, cfg, batch)

    def accumulate(params, batch):
        m = hyper.microbatches
        if m == 1:
            return single(params, batch)
        sliced = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])
                  for k, v in batch.items()}
        loss, metrics, grads = single(params, {k: v[0]
                                               for k, v in sliced.items()})
        for i in range(1, m):
            loss_i, metrics_i, grads_i = single(
                params, {k: v[i] for k, v in sliced.items()})
            grads = map_tree(torch.add, grads, grads_i)
            metrics = {k: metrics[k] + metrics_i[k] for k in metrics}
            loss = loss + loss_i
        inv = 1.0 / m
        return (loss * inv, {k: v * inv for k, v in metrics.items()},
                map_tree(lambda g: g * inv, grads))

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = accumulate(state.params, batch)
        lr = _lr(hyper, state.step)
        new_params, new_opt, gnorm = opt.adamw_update(
            grads, state.opt, state.params, lr,
            weight_decay=hyper.weight_decay, clip_norm=hyper.clip_norm)
        # exponential-moving router stats for the expert partition planner
        decay = 0.9
        new_state = TrainState(
            params=new_params, opt=new_opt, step=state.step + 1,
            expert_load=decay * state.expert_load
            + (1 - decay) * metrics["expert_load"],
            coactivation=decay * state.coactivation
            + (1 - decay) * metrics["coactivation"],
        )
        out_metrics = {"loss": loss, "ce": metrics["ce"],
                       "aux_loss": metrics["aux_loss"],
                       "grad_norm": gnorm, "lr": lr}
        return new_state, out_metrics

    return train_step
