"""Initial partitioning (paper §4.1 + Appendix A), PyTorch port of
``repro.core.initial``.

1. Focal-node selection: K nodes approximately maximizing the minimum
   pairwise geodesic distance (Eq. 11), by the paper's round-robin local
   improvement over neighbors, restarted from several random draws.
2. Hop-by-hop expansion: every machine grows a BFS cluster from its focal
   node; contested frontier nodes go to the claimant with the highest
   random priority that round (DESIGN.md §3.5).
3. Theorem A.1: the Erdős–Rényi expected-cluster-growth recursion, a
   property-test oracle for the expansion.

Randomness comes from a ``torch.Generator`` (or an int seed for one) in
place of the reference's threefry keys, so the same seed gives other draws
than the reference: the port is held to the reference by properties.
Draws are made on the host and copied to the device once per round.
"""
from __future__ import annotations

import numpy as np
import torch

from .problem import resolve_device

_INF = 0x3FFFFFFF


def _generator(generator) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


def _as_adjacency(adj, device) -> torch.Tensor:
    if isinstance(adj, torch.Tensor):
        return adj if device is None else adj.to(device)
    return torch.as_tensor(np.asarray(adj, np.float32),
                           device=resolve_device(device))


def bfs_distances(adj, sources, max_hops: int | None = None) -> torch.Tensor:
    """Geodesic hop distances from each source via frontier products.

    adj: (N, N) nonzero-where-edge tensor.  sources: (S,) int.
    Returns (S, N) int32 distances (``_INF`` where unreachable).  The
    product counts frontier neighbors; only ``> 0`` of it is used, so its
    rounding is irrelevant.
    """
    n = adj.shape[0]
    dev = adj.device
    max_hops = n if max_hops is None else max_hops
    nbr = (adj > 0).to(torch.float32)
    sources = torch.as_tensor(sources, device=dev).long()
    s = sources.shape[0]
    rows = torch.arange(s, device=dev)
    dist = torch.full((s, n), _INF, dtype=torch.int32, device=dev)
    dist[rows, sources] = 0
    frontier = torch.zeros((s, n), dtype=torch.float32, device=dev)
    frontier[rows, sources] = 1.0
    hop = 0
    while hop < max_hops and bool(frontier.any()):
        nxt = ((frontier @ nbr) > 0) & (dist == _INF)
        dist = torch.where(nxt, hop + 1, dist)
        frontier = nxt.to(torch.float32)
        hop += 1
    return dist


def _min_pairwise(dist_fk: torch.Tensor) -> torch.Tensor:
    """Minimum pairwise distance among focal nodes given (K, K) distances."""
    k = dist_fk.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=dist_fk.device)
    return torch.min(dist_fk + torch.where(eye, _INF, 0))


def select_focal_nodes(adj, num_machines: int, generator,
                       num_restarts: int = 4, max_rounds: int = 16,
                       device=None) -> torch.Tensor:
    """Appendix-A heuristic for Eq. 11 (max-min geodesic focal set)."""
    adj = _as_adjacency(adj, device)
    gen = _generator(generator)
    n = adj.shape[0]
    dev = adj.device
    all_dist = bfs_distances(adj, torch.arange(n, device=dev))   # (N, N)
    nbr = adj > 0
    nidx = torch.arange(n, device=dev)
    midx = torch.arange(num_machines, device=dev)
    best_set, best_score = None, None
    for _ in range(num_restarts):
        focals = torch.randperm(n, generator=gen)[:num_machines].to(dev)
        for _ in range(max_rounds):
            # round-robin: each machine moves its focal to the neighbor that
            # most increases the min distance to the other focals
            for m in range(num_machines):
                cur = focals[m:m + 1]
                d_to_others = all_dist[:, focals]                # (N, K)
                d_to_others = torch.where((midx == m)[None, :], _INF,
                                          d_to_others)
                score = torch.min(d_to_others, dim=1).values     # (N,)
                cand = nbr.index_select(0, cur)[0] | (nidx == cur)
                score = torch.where(cand, score, -1)
                best = torch.argmax(score).reshape(1)
                take = score.index_select(0, best) > score.index_select(0,
                                                                        cur)
                focals = focals.clone()
                focals[m:m + 1] = torch.where(take, best, cur)
        score = _min_pairwise(all_dist[focals][:, focals])
        if best_score is None:
            best_set, best_score = focals, score
        else:
            better = score > best_score        # first maximum wins ties
            best_set = torch.where(better, focals, best_set)
            best_score = torch.where(better, score, best_score)
    return best_set.to(torch.int32)


def expand_partitions(adj, focals, generator, num_machines: int,
                      max_hops: int | None = None,
                      device=None) -> torch.Tensor:
    """Hop-by-hop cluster growth from focal nodes with contention
    arbitration.  Disconnected leftovers go to the smallest cluster.
    Returns (N,) int32 assignment."""
    adj = _as_adjacency(adj, device)
    gen = _generator(generator)
    n = adj.shape[0]
    dev = adj.device
    max_hops = n if max_hops is None else max_hops
    nbr_t = (adj > 0).to(torch.float32).T.contiguous()
    midx = torch.arange(num_machines, device=dev)
    owner = torch.full((n,), -1, dtype=torch.int64, device=dev)
    owner[torch.as_tensor(focals, device=dev).long()] = midx
    hop = 0
    while hop < max_hops and bool((owner < 0).any()):
        prio = torch.rand(num_machines, generator=gen).to(dev)
        member = (owner[:, None] == midx[None, :]).to(torch.float32)
        reach = (nbr_t @ member) > 0                       # (N, K)
        claim_score = torch.where(reach, prio[None, :], -1.0)
        best_k = torch.argmax(claim_score, dim=1)
        claimable = torch.max(claim_score, dim=1).values >= 0
        grew = torch.any(claimable & (owner < 0))
        new_owner = torch.where((owner < 0) & claimable, best_k, owner)
        # if nothing grew but unowned nodes remain, the graph is
        # disconnected: put the rest on the smallest cluster and finish
        sizes = torch.sum((new_owner[:, None] == midx[None, :]).to(
            torch.int64), dim=0)
        smallest = torch.argmin(sizes)
        owner = torch.where(grew, new_owner,
                            torch.where(new_owner < 0, smallest, new_owner))
        hop += 1
    return owner.to(torch.int32)


def initial_partition(adj, num_machines: int, generator,
                      num_restarts: int = 4, device=None) -> torch.Tensor:
    """Full Appendix-A pipeline: focal selection + expansion.  ``adj`` is a
    tensor (its device is used) or an array (placed on ``device``, the card
    by default); ``generator`` is a ``torch.Generator`` or an int seed."""
    adj = _as_adjacency(adj, device)
    gen = _generator(generator)
    focals = select_focal_nodes(adj, num_machines, gen,
                                num_restarts=num_restarts)
    return expand_partitions(adj, focals, gen, num_machines)


def er_cluster_growth(num_nodes: int, p: float, hops: int) -> torch.Tensor:
    """Theorem A.1 recursion: expected BFS cluster size on G(n, p) per hop.

    N_{k+1} = N_k + (|V| - N_k) * (1 - (1-p)^(N_k - N_{k-1})),  N_1 = 1.
    """
    sizes = [1.0]
    prev, cur = 0.0, 1.0
    for _ in range(hops):
        nxt = cur + (num_nodes - cur) * (1.0 - (1.0 - p) ** (cur - prev))
        prev, cur = cur, nxt
        sizes.append(cur)
    return torch.tensor(sizes, dtype=torch.float32)
