"""The reference's parameter tree as the port's parameters.

``params_from_reference(tree)`` takes the tree of
``repro.models.transformer.init_params`` with numpy leaves (``np.asarray``
of each JAX array; the caller converts, so this module needs no JAX) and
returns the dict that :mod:`repro_torch.models.transformer` reads: the
same names, with the stacked ``blocks`` (leading L axis, nested dicts such
as an MoE's ``moe/{router,gate,up,down}`` included) split into a list of
per-layer dicts; other top-level entries, such as a hybrid's ``shared``
block, keep their nesting.  Values are copied exactly; bfloat16 leaves pass
through float32, which holds every bfloat16 value.

``train_state_from_reference(state)`` does the same for a
``repro.training.TrainState`` (numpy leaves): its params and Adam moments
split per layer, its count, step and router statistics as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.problem import resolve_device


def _tensor(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {name: _map(value, fn) for name, value in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_reference(tree: dict, device=None) -> dict:
    """The port's parameters from the reference's tree, on ``device``
    (default: the card)."""
    device = resolve_device(device)
    out = {name: _map(value, lambda a: _tensor(a, device))
           for name, value in tree.items() if name != "blocks"}
    layers = np.asarray(_first_leaf(tree["blocks"])).shape[0]
    out["blocks"] = [_map(tree["blocks"],
                          lambda a, i=i: _tensor(np.asarray(a)[i], device))
                     for i in range(layers)]
    return out


def param_count(params) -> int:
    """Elements in a parameter dict of the port."""
    if isinstance(params, list):
        return sum(param_count(p) for p in params)
    if isinstance(params, dict):
        return sum(param_count(p) for p in params.values())
    return params.numel()


def train_state_from_reference(state, device=None):
    """The port's ``TrainState`` from the reference's (any object with its
    fields ``params``, ``opt.mu``, ``opt.nu``, ``opt.count``, ``step``,
    ``expert_load``, ``coactivation``, numpy leaves), on ``device``
    (default: the card)."""
    from ..training.optimizer import AdamWState
    from ..training.train_step import TrainState
    device = resolve_device(device)
    return TrainState(
        params=params_from_reference(state.params, device),
        opt=AdamWState(mu=params_from_reference(state.opt.mu, device),
                       nu=params_from_reference(state.opt.nu, device),
                       count=_tensor(state.opt.count, device)),
        step=_tensor(state.step, device),
        expert_load=_tensor(state.expert_load, device),
        coactivation=_tensor(state.coactivation, device))
