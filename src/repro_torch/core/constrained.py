"""Capacity-constrained repair for game partitions, PyTorch port of
``repro.core.constrained``.

The Nash refinement balances *weighted* load but leaves partition
cardinalities free.  Expert-parallel placement needs exactly E/K experts
per device group (the weight arrays are evenly sharded), and pipeline
stages need contiguous layer blocks.  These repairs project a refined
assignment onto the constraint set while disturbing the potential as little
as possible.
"""
from __future__ import annotations

import numpy as np
import torch

from . import costs
from .problem import as_assignment, make_state


def equalize_cardinality(problem, assignment,
                         framework: str = costs.C_FRAMEWORK) -> torch.Tensor:
    """Repair to exactly-equal partition sizes (N must divide by K).

    Greedy: while some machine is over-full, move its *least dissatisfied-
    to-stay* node (the one whose cost increases least) to the under-full
    machine that minimizes the node's cost.  O(N) moves, each O(NK).

    Every move takes one node from an over-full machine to an under-full
    one, so the number of moves is the total excess over the target,
    read once; the loop then runs without waiting on the card.  Ties go
    to the lowest index, as the reference's ``argmin``.
    """
    n, k = problem.num_nodes, problem.num_machines
    if n % k:
        raise ValueError(f"equalize_cardinality needs N divisible by K; got "
                         f"N={n}, K={k}")
    target = n // k
    r = as_assignment(assignment, problem.device)
    counts = torch.bincount(r.long(), minlength=k)
    excess = int(torch.clamp(counts - target, min=0).sum())   # host sync
    kidx = torch.arange(k, device=problem.device)
    nidx = torch.arange(n, device=problem.device)
    for _ in range(excess):
        over = counts > target
        under = counts < target
        cost = costs.cost_matrix(problem, make_state(problem, r), framework)
        current = cost.gather(1, r.long()[:, None])[:, 0]
        # candidate destination cost restricted to under-full machines
        dest_cost = torch.where(under[None, :], cost, torch.inf)
        min_dest = torch.min(dest_cost, dim=1, keepdim=True).values
        best_dest = torch.where(dest_cost == min_dest, kidx, k).min(1).values
        regret = min_dest[:, 0] - current     # cost increase if forced out
        masked = torch.where(over[r.long()], regret, torch.inf)
        pick = torch.where(masked == masked.min(), nidx, n).min()
        dest = best_dest[pick]
        counts = counts - (kidx == r[pick]).long() + (kidx == dest).long()
        r = torch.where(nidx == pick, dest.to(torch.int32), r)
    return r


def contiguous_stage_dp(weights, num_stages: int):
    """Optimal contiguous partition of a chain (minimize max stage load).

    Classic O(L^2 * K) interval DP — the oracle the game-based stage
    assignment is compared against in tests and benchmarks.  Host-side.
    """
    w = np.asarray(weights, np.float64)
    L = w.shape[0]
    K = num_stages
    prefix = np.concatenate([[0.0], np.cumsum(w)])

    def seg(i, j):                       # load of layers [i, j)
        return prefix[j] - prefix[i]

    dp = np.full((K + 1, L + 1), np.inf)
    cut = np.zeros((K + 1, L + 1), np.int64)
    dp[0, 0] = 0.0
    for k in range(1, K + 1):
        for j in range(1, L + 1):
            for i in range(k - 1, j):
                val = max(dp[k - 1, i], seg(i, j))
                if val < dp[k, j]:
                    dp[k, j] = val
                    cut[k, j] = i
    bounds = [L]
    j = L
    for k in range(K, 0, -1):
        j = int(cut[k, j])
        bounds.append(j)
    bounds = bounds[::-1]
    assignment = np.zeros(L, np.int32)
    for s in range(K):
        assignment[bounds[s]:bounds[s + 1]] = s
    return assignment, float(dp[K, L])


def make_contiguous(assignment, num_stages: int) -> torch.Tensor:
    """Project an arbitrary chain assignment onto contiguous stages by
    sorting stage ids along the chain (stable, preserves stage sizes)."""
    r = assignment if isinstance(assignment, torch.Tensor) \
        else torch.as_tensor(np.asarray(assignment, np.int32))
    return torch.sort(r.to(torch.int32), stable=True).values
