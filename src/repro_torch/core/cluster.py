"""Coordinated cluster transfers (paper §7 future work, §4.4 discussion),
PyTorch port of ``repro.core.cluster``.

Single-node best response converges to a Nash equilibrium that may be a
poor local optimum of the potential.  Following the §4.4 suggestion of
restricting the joint strategy space, :func:`cluster_move_pass` evaluates,
for the most dissatisfied node of each machine, the joint transfer of its
h-hop same-machine neighborhood to each destination machine, and applies
the best potential-decreasing move.  Every accepted move descends the
global potential: the pass compares full global costs.

Both representations are taken: the h-hop mask walks the dense adjacency
(one boolean product per hop) or the sparse edge list
(:func:`repro_torch.core.sparse.frontier_expand`, O(E) per hop), and the
candidate costs go through :mod:`repro_torch.core.costs`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import costs
from .problem import as_assignment, make_state
from .sparse import frontier_expand


class ClusterMoveResult(NamedTuple):
    assignment: torch.Tensor
    moved: torch.Tensor       # bool — whether any cluster move was applied
    gain: torch.Tensor        # potential decrease achieved (>= 0)


def h_hop_mask(problem, seed_node, hops: int) -> torch.Tensor:
    """Boolean mask of the nodes within ``hops`` of ``seed_node``
    (inclusive), either representation; the two give identical masks on
    converted problems."""
    n = problem.num_nodes
    seed = torch.as_tensor(seed_node, device=problem.device).long()
    mask = torch.zeros(n, dtype=torch.bool, device=problem.device)
    mask[seed.reshape(1)] = True
    if costs.is_sparse(problem):
        for _ in range(hops):
            mask = frontier_expand(problem, mask)
        return mask
    nbr = (problem.adjacency > 0).to(torch.float32)
    for _ in range(hops):
        # counts of masked neighbors are small integers: exact in f32
        mask = mask | ((mask.to(torch.float32) @ nbr) > 0)
    return mask


def cluster_move_pass(problem, assignment,
                      framework: str = costs.C_FRAMEWORK,
                      hops: int = 1) -> ClusterMoveResult:
    """One pass: for every machine's most dissatisfied node, try moving its
    h-hop owned neighborhood jointly to every machine; apply the single
    best strictly-improving move found across all machines.

    The candidate costs are full :func:`repro_torch.core.costs.global_cost`
    evaluations (O(N^2) dense, O(E) sparse each), so an accepted move
    descends the global potential by construction.
    """
    k = problem.num_machines
    dev = problem.device
    assignment = as_assignment(assignment, dev)
    state = make_state(problem, assignment)
    cost = costs.cost_matrix(problem, state, framework)
    dissat, _ = costs.dissatisfaction(problem, state, framework, cost=cost)
    base = costs.global_cost(problem, assignment, framework)

    kidx = torch.arange(k, device=dev)
    owned = assignment.long()[None, :] == kidx[:, None]          # (K, N)
    masked = torch.where(owned, dissat[None, :], -float("inf"))
    seeds = torch.argmax(masked, dim=1)                          # (K,)

    dest_cost, dest_k, clusters = [], [], []
    for m in range(k):
        seed = seeds[m]
        home = assignment[seed]
        cluster = h_hop_mask(problem, seed, hops) & (assignment == home)
        cand = torch.stack([
            costs.global_cost(problem,
                              torch.where(cluster, dest, assignment)
                              .to(torch.int32), framework)
            for dest in range(k)])
        cand = torch.where(kidx == home, float("inf"), cand)
        best_k = torch.argmin(cand)                              # first min
        dest_cost.append(cand[best_k])
        dest_k.append(best_k)
        clusters.append(cluster)
    dest_cost = torch.stack(dest_cost)
    best_m = torch.argmin(dest_cost)
    gain = base - dest_cost[best_m]
    moved = gain > 1e-6
    new_assignment = torch.where(
        moved & torch.stack(clusters)[best_m],
        torch.stack(dest_k)[best_m].to(torch.int32), assignment)
    return ClusterMoveResult(assignment=new_assignment.to(torch.int32),
                             moved=moved,
                             gain=torch.clamp(gain, min=0.0))
