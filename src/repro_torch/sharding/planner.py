"""PartitionPlanner: the paper's game as a first-class framework feature
(port of ``repro.sharding.planner``).

Two production uses (DESIGN.md §4):

  * **Expert placement (EP)** — experts are the LPs: node weight = EMA of
    tokens routed to the expert (dynamic load, from TrainState router
    stats), edge weight = co-activation counts (tokens routed to both
    experts; splitting a strongly co-activated pair across device groups
    costs all-to-all traffic).  Machines = expert-parallel device groups.
    The refined Nash assignment is repaired to exactly E/K experts per
    group (weight arrays shard evenly) and emitted as a permutation
    applied to the expert-stacked weight tensors.

  * **Pipeline-stage assignment (PP)** — layers are LPs on a chain: node
    weight = per-layer FLOPs, edge weight = activation bytes.  The refined
    assignment is projected to contiguous stages and compared against the
    O(L^2 K) interval-DP oracle.

Both run the *same* ``refine`` the DES simulator uses — one algorithm,
three deployments.  On the card each refinement turn is kernel 1; on CPU
tensors its twin.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import costs as game_costs
from ..core.constrained import (contiguous_stage_dp, equalize_cardinality,
                                make_contiguous)
from ..core.problem import make_problem, resolve_device
from ..core.refine import refine
from ..tree import map_with_path

_EXPERT_LEAVES = ("moe/gate", "moe/up", "moe/down")


def _group_loads(assignment: torch.Tensor, load: torch.Tensor,
                 num_groups: int) -> np.ndarray:
    """f32 load of each group, summed on the host in index order (the
    reference's scatter-add order)."""
    out = np.zeros((num_groups,), np.float32)
    np.add.at(out, assignment.cpu().numpy(), load.cpu().numpy())
    return out


def expert_placement(expert_load, coactivation, num_groups: int, *,
                     mu: float = 1.0, current=None,
                     framework: str = game_costs.C_FRAMEWORK, device=None):
    """Returns (permutation (E,), assignment (E,), stats dict).

    ``permutation[i]`` = expert to place at slot i; slots are contiguous
    per group, matching a leading expert dim sharded over the groups.
    Runs on ``expert_load``'s device when it is a tensor, else on
    ``device`` (default: the card)."""
    if device is None and isinstance(expert_load, torch.Tensor):
        device = expert_load.device
    device = resolve_device(device)
    f32 = torch.float32
    e = int(expert_load.shape[0])
    if e % num_groups:
        raise ValueError(f"{e} experts do not split into {num_groups} "
                         f"equal groups")
    load = torch.as_tensor(expert_load, dtype=f32, device=device) + 1e-6
    coact = torch.as_tensor(coactivation, dtype=f32, device=device)
    # normalize edge weights to the load scale so mu means the same thing
    # across training stages
    denom = torch.clamp(torch.max(coact), min=1e-6)
    coact = coact * (torch.max(load) / denom)
    problem = make_problem(coact, load,
                           torch.full((num_groups,), 1.0, dtype=f32),
                           mu=mu, device=device)
    if current is None:
        current = torch.arange(e, dtype=torch.int32, device=device) \
            % num_groups
    current = torch.as_tensor(current, dtype=torch.int32, device=device)
    res = refine(problem, current, framework, max_turns=4 * e)
    balanced = equalize_cardinality(problem, res.assignment, framework)
    perm = torch.argsort(balanced, stable=True).to(torch.int32)

    mean = (torch.sum(load) / num_groups).cpu().numpy()      # f32
    stats = {
        "imbalance_before": float(
            _group_loads(current, load, num_groups).max() / mean),
        "imbalance_after": float(
            _group_loads(balanced, load, num_groups).max() / mean),
        "moves": int(res.num_moves),
    }
    return perm, balanced, stats


def apply_expert_permutation(params: dict, perm: torch.Tensor) -> dict:
    """Permute every layer's expert-stacked MoE weights (``moe/gate``,
    ``moe/up``, ``moe/down``: dim 0 is the expert) and its router's
    columns (``moe/router``: the last dim) to match."""
    perm = perm.to(torch.int64)

    def fix(path, leaf):
        if any(name in path for name in _EXPERT_LEAVES):
            return leaf[perm.to(leaf.device)]
        if "moe/router" in path:
            return leaf[..., perm.to(leaf.device)]
        return leaf

    return map_with_path(fix, params)


def stage_assignment(layer_cost, boundary_bytes, num_stages: int, *,
                     mu: float = 1.0,
                     framework: str = game_costs.C_FRAMEWORK, device=None):
    """Game-refined contiguous pipeline stages, on ``device`` (default:
    the card).

    layer_cost: (L,) per-layer FLOPs (or time) estimates.
    boundary_bytes: scalar or (L-1,) activation bytes across each boundary.
    Returns (assignment (L,), game_max_load, dp_max_load).
    """
    device = resolve_device(device)
    f32 = torch.float32
    layer_cost = torch.as_tensor(np.asarray(layer_cost, np.float32),
                                 device=device)
    n = layer_cost.shape[0]
    bb = torch.broadcast_to(torch.as_tensor(
        np.asarray(boundary_bytes, np.float32), device=device), (n - 1,))
    adj = torch.zeros((n, n), dtype=f32, device=device)
    idx = torch.arange(n - 1, device=device)
    adj[idx, idx + 1] = bb
    adj[idx + 1, idx] = bb
    # scale cut weights relative to compute so mu stays interpretable
    adj = adj * (torch.mean(layer_cost)
                 / torch.clamp(torch.mean(bb), min=1e-9))
    problem = make_problem(adj, layer_cost,
                           torch.full((num_stages,), 1.0, dtype=f32),
                           mu=mu, device=device)
    init = (torch.arange(n, dtype=torch.int32, device=device)
            * num_stages) // n
    res = refine(problem, init, framework, max_turns=8 * n)
    game = make_contiguous(res.assignment, num_stages)
    loads = _group_loads(game, layer_cost, num_stages)
    _, dp_max = contiguous_stage_dp(layer_cost.cpu().numpy(), num_stages)
    return game, float(loads.max()), dp_max


@dataclasses.dataclass
class PartitionPlanner:
    """Stateful wrapper the train driver calls every ``interval`` steps."""
    num_groups: int
    interval: int = 100
    mu: float = 1.0
    _last_perm: torch.Tensor | None = None

    def maybe_replan(self, step: int, state):
        """Returns (state, stats|None): permutes the expert weights, their
        Adam moments and the router statistics when a replan moves an
        expert."""
        if self.num_groups <= 1 or step == 0 or step % self.interval:
            return state, None
        if float(torch.sum(state.expert_load)) <= 0:
            return state, None
        perm, _, stats = expert_placement(
            state.expert_load, state.coactivation, self.num_groups,
            mu=self.mu)
        if bool(torch.all(perm == torch.arange(perm.shape[0],
                                               device=perm.device))):
            return state, stats
        p = perm.to(torch.int64)
        state = state._replace(
            params=apply_expert_permutation(state.params, perm),
            opt=state.opt._replace(
                mu=apply_expert_permutation(state.opt.mu, perm),
                nu=apply_expert_permutation(state.opt.nu, perm)),
            expert_load=state.expert_load[p],
            coactivation=state.coactivation[p][:, p],
        )
        self._last_perm = perm
        return state, stats
