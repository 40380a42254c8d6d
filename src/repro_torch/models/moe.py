"""Mixture-of-Experts block with grouped capacity dispatch (port of
``repro.models.moe``).

Tokens are split into groups of ``moe_group_size``; within a group every
(token, slot) pair routed to an expert takes the next place in that
expert's capacity buffer, in token-major order, and pairs past the
capacity are dropped.  Three ``moe_impl``s compute the same function:

  * ``scatter`` (the configs' default) — kept pairs are copied into the
    (G, E, C, d) buffer by plain index assignment, the experts run on the
    buffer, and each token gathers its k outputs back;
  * ``einsum`` — GShard-style one-hot dispatch and combine tensors and
    batched products (the reference's SPMD layout);
  * ``dense`` — every expert on every token, the top-k combine only: the
    oracle of the tests.

The router reads ``x`` and its weights in f32 whatever the compute dtype,
as the reference does (``cast_params`` keeps ``router`` in f32).  Top-k
breaks ties toward the lowest expert id, as ``jax.lax.top_k`` does, by a
stable descending sort.  The scatter writes each kept (group, expert,
place) exactly once and sends the dropped pairs to a spare place past the
capacity that nothing reads, so no float accumulation (``index_add_``,
``index_put_(accumulate=True)``, atomics) runs and no host sync is needed.
The ``einsum`` path hints its tensors at the reference's five sites
(``sharding.hints.hint``: groups over the data axes, experts over
'model'); with no mesh active a hint returns its input, so a path on one
card runs the ops it ran before.

The router's statistics (``MoEStats``: auxiliary loss, per-expert load,
expert co-activation counts) are what an expert placement planner reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..sharding.hints import (DP, fitted_spec, hint, mesh_axis_sizes,
                              on_mesh, relayout)
from .config import ModelConfig
from .layers import normal_init

MOE_IMPLS = ("scatter", "einsum", "dense")


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor      # () load-balancing auxiliary loss
    expert_load: torch.Tensor   # (E,) fraction of tokens routed to each expert
    coactivation: torch.Tensor  # (E, E) co-routing counts, zero diagonal


class Dispatch(NamedTuple):
    """Where each (token, slot) pair goes: ``G`` groups of ``sg`` tokens,
    ``cap`` places an expert and group; (G, sg * k) tensors in
    token-major order."""
    sg: int
    groups: int
    cap: int
    expert: torch.Tensor        # expert id of each pair
    place: torch.Tensor         # its place in the expert's buffer
    keep: torch.Tensor          # real (not padding) and within capacity


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> dict:
    """The reference's shapes and scales, drawn from ``generator`` on its
    device (or on ``device``) in the parameter dtype: router and gate/up
    ``d**-0.5``, down ``f**-0.5``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dtype = cfg.pdtype()
    scale_in = d ** -0.5
    return {
        "router": normal_init(generator, (d, e), scale_in, dtype, device),
        "gate": normal_init(generator, (e, d, f), scale_in, dtype, device),
        "up": normal_init(generator, (e, d, f), scale_in, dtype, device),
        "down": normal_init(generator, (e, f, d), f ** -0.5, dtype, device),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row (no
    range check, so no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(params: dict, cfg: ModelConfig, x_flat: torch.Tensor):
    """Top-k routing in f32.  x_flat: (T, d) -> weights (T, k) f32, ids
    (T, k) int64, MoEStats."""
    e, k = cfg.num_experts, cfg.top_k
    f32 = torch.float32
    logits = x_flat.to(f32) @ params["router"].to(f32)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top[:, :k], order[:, :k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    # Switch-style aux loss: E * sum_e f_e * p_e
    frac = torch.mean(_one_hot(ids[:, 0], e, f32), dim=0)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))

    # expert load and the co-activation graph
    full_assign = torch.sum(_one_hot(ids, e, f32), dim=1)        # (T, E)
    load = torch.mean(full_assign, dim=0)
    coact = (full_assign.T @ full_assign) \
        * (1.0 - torch.eye(e, dtype=f32, device=x_flat.device))
    return weights, ids, MoEStats(aux_loss=aux, expert_load=load,
                                  coactivation=coact)


def _dispatch(ids: torch.Tensor, cfg: ModelConfig, *,
              dropless: bool) -> Dispatch:
    """Capacity places of the (token, slot) pairs of ``ids`` (T, k): the
    token stream padded to groups of ``min(moe_group_size, T)``, each
    pair's place the count of earlier real pairs of its group routed to
    its expert (an exclusive cumsum, token-major), kept below the
    capacity ``max(1, int(capacity_factor * sg * k / E))`` (``sg`` when
    ``dropless``)."""
    t, k = ids.shape
    e = cfg.num_experts
    sg = min(cfg.moe_group_size, t)
    groups = -(-t // sg)
    cap = sg if dropless else max(1, int(cfg.capacity_factor * sg * k / e))
    expert = F.pad(ids, (0, 0, 0, groups * sg - t)).reshape(groups, sg * k)
    pair = torch.arange(groups * sg * k, device=ids.device).reshape(
        groups, sg * k)
    real = pair // k < t                                       # not padding
    onehot = _one_hot(expert, e, torch.int32) * real[..., None]
    pos = torch.cumsum(onehot, dim=1) - onehot                  # exclusive
    place = torch.gather(pos, -1, expert[..., None])[..., 0]
    keep = (place < cap) & real                                 # overflow drop
    return Dispatch(sg=sg, groups=groups, cap=cap, expert=expert,
                    place=place, keep=keep)


def _experts(params: dict, buf: torch.Tensor, dtype) -> torch.Tensor:
    """SwiGLU over capacity buffers.  buf: (G, E, C, d) -> (G, E, C, d)."""
    gate = torch.einsum("gecd,edf->gecf", buf, params["gate"].to(dtype))
    up = torch.einsum("gecd,edf->gecf", buf, params["up"].to(dtype))
    return torch.einsum("gecf,efd->gecd", F.silu(gate) * up,
                        params["down"].to(dtype))


def _token_rows(t: torch.Tensor, b: int) -> torch.Tensor:
    """Under a mesh, the (B * S, d) tokens ``t`` sharded over the data
    axes only where the batch ``b`` divides them, else replicated: DTensor
    cannot unflatten a dim whose shards do not fall on batch boundaries,
    nor take the gradient of a flatten whose shards do not."""
    if not on_mesh(t):
        return t
    return relayout(t, fitted_spec(mesh_axis_sizes(), (b,), (DP,))[0])


def _unflatten_tokens(y: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """The first ``b * s`` rows of ``y`` (G * sg, d) as (B, S, d)."""
    y = _token_rows(y.reshape(-1, y.shape[-1])[:b * s], b)
    return y.reshape(b, s, y.shape[-1])


def moe_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              dropless: bool = False):
    """x: (B, S, d) -> (B, S, d), MoEStats.

    ``dropless=True`` sizes each expert's capacity to the whole group, so
    no pair is dropped: the decode path's setting, where a dropped token
    would corrupt generation (cheap there: T is the batch)."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl must be one of {MOE_IMPLS}; got "
                         f"{cfg.moe_impl!r}")
    b, s, d = x.shape
    dtype = x.dtype
    t = b * s
    x_flat = _token_rows(x.reshape(t, d), b)
    weights, ids, stats = _route(params, cfg, x_flat)
    e, k = cfg.num_experts, cfg.top_k

    if cfg.moe_impl == "dense":
        gate = torch.einsum("td,edf->tef", x_flat, params["gate"].to(dtype))
        up = torch.einsum("td,edf->tef", x_flat, params["up"].to(dtype))
        y_all = torch.einsum("tef,efd->ted", F.silu(gate) * up,
                             params["down"].to(dtype))
        # a token's k experts are distinct: one write a (token, expert)
        combine = torch.zeros((t, e), dtype=torch.float32, device=x.device)
        combine[torch.arange(t, device=x.device)[:, None], ids] = weights
        y = torch.einsum("te,ted->td", combine.to(dtype), y_all)
        return y.reshape(b, s, d), stats

    plan = _dispatch(ids, cfg, dropless=dropless)
    sg, groups, cap = plan.sg, plan.groups, plan.cap
    pad = groups * sg - t
    xg = F.pad(x_flat, (0, 0, 0, pad)).reshape(groups, sg, d)
    wg = F.pad(weights, (0, 0, 0, pad)).reshape(groups, sg * k)
    g_idx = torch.arange(groups, device=x.device)[:, None].expand(
        groups, sg * k)
    tok_idx = (torch.arange(sg * k, device=x.device) // k)[None, :].expand(
        groups, sg * k)

    if cfg.moe_impl == "einsum":
        # each kept pair owns one (group, token, expert, place) entry, so
        # the one-hot products summed over the k slots are single writes
        kept = plan.keep.to(dtype)
        disp = (_one_hot(plan.expert, e, dtype)[..., :, None]
                * _one_hot(plan.place, cap, dtype)[..., None, :]
                * kept[..., None, None]).reshape(groups, sg, k, e, cap)
        dispatch = torch.sum(disp, dim=2)                       # (G,sg,E,C)
        combine = torch.sum(disp * wg.reshape(groups, sg, k, 1, 1).to(dtype),
                            dim=2)
        xg = hint(xg, DP, None, None)
        dispatch = hint(dispatch, DP, None, "model", None)
        buf = torch.einsum("gsec,gsd->gecd", dispatch, xg)
        buf = hint(buf, DP, "model", None, None)
        out_buf = _experts(params, buf, dtype)                  # (G,E,C,d)
        out_buf = hint(out_buf, DP, "model", None, None)
        y = torch.einsum("gsec,gecd->gsd", combine, out_buf)
        y = hint(y, DP, None, None)
        return _unflatten_tokens(y, b, s), stats

    # place ``cap`` is the spare that takes every dropped pair: the kept
    # places are written once each and the experts never read the spare
    buf = torch.zeros((groups, e, cap + 1, d), dtype=dtype, device=x.device)
    write = torch.where(plan.keep, plan.place, cap)
    buf[g_idx, plan.expert, write] = xg[g_idx, tok_idx]
    out_buf = _experts(params, buf[:, :, :cap], dtype)         # (G,E,C,d)

    safe = torch.where(plan.keep, plan.place, cap - 1)
    gathered = out_buf[g_idx, plan.expert, safe]               # (G,sg*k,d)
    contrib = gathered * (wg * plan.keep)[..., None].to(dtype)
    y = torch.sum(contrib.reshape(groups, sg, k, d), dim=2)
    return _unflatten_tokens(y, b, s), stats
