"""Comparison baselines from the paper's §2 literature review.

These are the centralized heuristics the paper positions itself against:

  * ``random_partition``       — uniform assignment (sanity floor).
  * ``greedy_load_partition``  — longest-processing-time list scheduling:
                                 balances load, ignores the cut (the classic
                                 load-balancing-only strawman).
  * ``kernighan_lin_refine``   — [Kernighan & Lin 1970] pairwise exchange
                                 refinement on the cut, K-way via pair sweeps.
  * ``spectral_bisection``     — [Pothen et al. 1990] recursive Fiedler-vector
                                 bisection (dense eigendecomposition).
  * ``nandy_loucks_refine``    — [Nandy & Loucks 1993], the paper's closest
                                 prior work: gain-based migration minimizing
                                 only the cut, each node allowed to migrate
                                 at most once ("forced convergence").

All are host-side (numpy) reference implementations — they exist to be
*measured against*, not to be fast; benchmarks compare their C_0 / Ct_0 /
simulation-time against the game-theoretic refinement.
"""
from __future__ import annotations

import numpy as np


def random_partition(n: int, k: int, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=n).astype(np.int32)


def greedy_load_partition(node_weights: np.ndarray, speeds: np.ndarray) -> np.ndarray:
    """LPT list scheduling: heaviest node to the machine with most headroom."""
    n = node_weights.shape[0]
    k = speeds.shape[0]
    order = np.argsort(-node_weights)
    loads = np.zeros(k)
    out = np.zeros(n, np.int32)
    for i in order:
        m = int(np.argmin((loads + node_weights[i]) / speeds))
        out[i] = m
        loads[m] += node_weights[i]
    return out


def _cut_gain(adj: np.ndarray, r: np.ndarray, i: int, dest: int) -> float:
    """Cut decrease if node i moves to dest (positive = improvement)."""
    internal_new = adj[i, r == dest].sum()
    internal_old = adj[i, r == r[i]].sum()
    return float(internal_new - internal_old)


def kernighan_lin_refine(adj: np.ndarray, assignment: np.ndarray,
                         max_passes: int = 4) -> np.ndarray:
    """K-way K-L: for every machine pair, greedily swap the best node pair
    while positive gain exists (bounded passes)."""
    r = assignment.astype(np.int32).copy()
    k = int(r.max()) + 1
    for _ in range(max_passes):
        improved = False
        for a in range(k):
            for b in range(a + 1, k):
                ia = np.flatnonzero(r == a)
                ib = np.flatnonzero(r == b)
                if ia.size == 0 or ib.size == 0:
                    continue
                # gains of single moves
                ga = np.array([_cut_gain(adj, r, i, b) for i in ia])
                gb = np.array([_cut_gain(adj, r, j, a) for j in ib])
                bi, bj = int(np.argmax(ga)), int(np.argmax(gb))
                i, j = int(ia[bi]), int(ib[bj])
                # pair swap gain corrects for the (i, j) edge counted twice
                gain = ga[bi] + gb[bj] - 2.0 * adj[i, j]
                if gain > 1e-9:
                    r[i], r[j] = b, a
                    improved = True
        if not improved:
            break
    return r


def spectral_bisection(adj: np.ndarray, k: int) -> np.ndarray:
    """Recursive Fiedler bisection down to k parts (k must be a power of 2
    for clean halving; otherwise the last level splits unevenly)."""
    def bisect(nodes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        sub = adj[np.ix_(nodes, nodes)]
        deg = sub.sum(1)
        lap = np.diag(deg) - sub
        vals, vecs = np.linalg.eigh(lap)
        fiedler = vecs[:, 1] if vecs.shape[1] > 1 else vecs[:, 0]
        med = np.median(fiedler)
        left = nodes[fiedler <= med]
        right = nodes[fiedler > med]
        if left.size == 0 or right.size == 0:   # degenerate: split by order
            half = nodes.size // 2
            left, right = nodes[:half], nodes[half:]
        return left, right

    parts = [np.arange(adj.shape[0])]
    while len(parts) < k:
        parts.sort(key=lambda p: -p.size)
        left, right = bisect(parts.pop(0))
        parts.extend([left, right])
    out = np.zeros(adj.shape[0], np.int32)
    for m, p in enumerate(parts):
        out[p] = m
    return out


def nandy_loucks_refine(adj: np.ndarray, assignment: np.ndarray) -> np.ndarray:
    """[Nandy & Loucks 1993]: iterative gain-only migration, cut objective,
    each node migrates at most once (the paper's "forced convergence")."""
    r = assignment.astype(np.int32).copy()
    k = int(r.max()) + 1
    n = r.shape[0]
    migrated = np.zeros(n, bool)
    while True:
        best = (0.0, -1, -1)
        for i in range(n):
            if migrated[i]:
                continue
            for dest in range(k):
                if dest == r[i]:
                    continue
                g = _cut_gain(adj, r, i, dest)
                if g > best[0] + 1e-12:
                    best = (g, i, dest)
        if best[1] < 0:
            break
        _, i, dest = best
        r[i] = dest
        migrated[i] = True
    return r
