"""Random graph models used in the paper's experiments (§5.1, §6.1).

Host-side (numpy) generation — graphs are *data* fed to the JAX programs, so
this lives in the data-pipeline layer, mirroring how token pipelines sit
outside jit.

Two output forms per model:

  * the original **dense** generators return a symmetric float32 (N, N)
    adjacency with zero diagonal (1.0 marks an edge; weights applied
    separately) — convenient up to a few thousand nodes;
  * the ``*_edges`` variants emit the **undirected edge list**
    ``(senders, receivers)`` directly (each edge once, ``s < r``), never
    touching an O(N^2) array, for the sparse runtime of DESIGN.md §13 —
    feed them to :func:`repro.core.sparse.make_sparse_problem` via
    :func:`random_weights_edges`.  The edge variants draw from the same
    model family (same per-node distributions, bounds included) but are
    *separate RNG streams* from their dense twins — fixed seeds give
    different graphs across the two forms.

Models:

  * ``random_degree_graph``      — §5.1 study: per-node degree drawn from
                                   [dmin, dmax], random distinct targets.
  * ``preferential_attachment``  — §6 Fig. 7: Barabási–Albert style model
                                   (Bu–Towsley's Internet-like generator).
  * ``specialized_geometric``    — §6 Fig. 8: nodes get 2-D coordinates and
                                   link to nodes chosen among their 15
                                   nearest neighbors.
  * ``erdos_renyi``              — Appendix A / Thm A.1 property tests.

All generators (both forms) guarantee CONNECTED output — the paper's §3
assumptions exclude disconnected graphs — by stitching stray components
into the giant component with unit edges (:func:`_ensure_connected`,
union-find over edges).
"""
from __future__ import annotations

import numpy as np


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def _empty(n: int) -> np.ndarray:
    return np.zeros((n, n), np.float32)


def _component_labels(n: int, senders: np.ndarray,
                      receivers: np.ndarray) -> np.ndarray:
    """Connected-component labels, each component labeled by its MINIMUM
    node id — union-find via vectorized min-hooking + pointer jumping,
    O(E · log N) total instead of the old per-node label-propagation
    loop's O(N^2 · iters).

    The min-id labeling is exactly what the previous label-propagation
    implementation converged to, so everything downstream (component
    enumeration order, stitch RNG consumption) is unchanged bitwise —
    pinned by ``tests/test_graphs.py`` against a reference copy of the
    old algorithm.
    """
    labels = np.arange(n)
    if senders.size == 0:
        return labels
    while True:
        prev = labels
        m = np.minimum(labels[senders], labels[receivers])
        nxt = labels.copy()
        np.minimum.at(nxt, senders, m)
        np.minimum.at(nxt, receivers, m)
        nxt = nxt[nxt]          # pointer-jump: follow the label's label
        nxt = nxt[nxt]
        if np.array_equal(nxt, prev):
            return nxt
        labels = nxt


def _stitch_components(labels: np.ndarray, rng: np.random.Generator):
    """Unit edges joining every stray component to the (growing) giant.

    Component roots are visited in ascending min-node-id order; for each,
    one random member links to one random member of the giant — the same
    rule (and the same RNG consumption sequence) as the original dense
    implementation, pinned bitwise by ``tests/test_graphs.py``.  Returns
    the (a, b) endpoint lists.  O(N) per stray component (the growing
    giant's member list is rescanned each step) — fine for the dense
    generators, whose representation is O(N^2) anyway; the edge-list
    path uses the vectorized :func:`_stitch_components_star` instead.
    """
    roots = np.unique(labels)
    extra_a, extra_b = [], []
    if roots.size > 1:
        counts = np.bincount(labels, minlength=labels.size)[roots]
        giant = roots[np.argmax(counts)]
        for r in roots:
            if r == giant:
                continue
            a = rng.choice(np.flatnonzero(labels == r))
            b = rng.choice(np.flatnonzero(labels == giant))
            extra_a.append(int(a))
            extra_b.append(int(b))
            labels[labels == r] = giant
    return extra_a, extra_b


def _stitch_components_star(labels: np.ndarray, rng: np.random.Generator):
    """Vectorized stitch for the edge-list path: every stray component
    links one uniform-random member to one uniform-random member of the
    INITIAL giant (a star onto the giant rather than the dense path's
    sequentially growing giant) — O(N log N) total however many
    components there are, where the faithful sequential rule is O(N) per
    stray.  Same connectivity guarantee; different (but documented) RNG
    stream, which is fine because the ``*_edges`` generators never
    promise draw-for-draw parity with their dense twins.
    """
    n = labels.size
    roots = np.unique(labels)
    if roots.size <= 1:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    counts = np.bincount(labels, minlength=n)[roots]
    giant = roots[np.argmax(counts)]
    # nodes grouped by component, node-id ascending inside each group
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.searchsorted(sorted_labels, roots, side="left")
    sizes = np.concatenate([np.diff(starts), [n - starts[-1]]])
    stray = roots != giant
    gi = int(np.flatnonzero(~stray)[0])
    # one uniform member per stray + one uniform giant member per stray
    a = order[starts[stray]
              + rng.integers(0, sizes[stray], size=int(stray.sum()))]
    b = order[starts[gi]
              + rng.integers(0, sizes[gi], size=int(stray.sum()))]
    return a.astype(np.int64), b.astype(np.int64)


def _ensure_connected(adj: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Stitch components together with zero-cost... no — unit edges.

    The paper (§3) notes a disconnected graph can be connected by adding
    zero-weight edges; for topology generation we instead add a unit edge
    from each stranded component to the giant component, which keeps BFS
    utilities simple.  Components come from union-find over the edge
    list (:func:`_component_labels`) — O(E) instead of the previous
    O(N^2·iters) label propagation, with identical stitched output on
    fixed seeds.
    """
    n = adj.shape[0]
    s, r = np.nonzero(adj)
    labels = _component_labels(n, s, r)
    extra_a, extra_b = _stitch_components(labels, rng)
    for a, b in zip(extra_a, extra_b):
        adj[a, b] = adj[b, a] = 1.0
    return adj


def _ensure_connected_edges(n: int, senders: np.ndarray,
                            receivers: np.ndarray,
                            rng: np.random.Generator):
    """Edge-list twin of :func:`_ensure_connected`: returns the input
    undirected pairs plus one stitch edge per stray component (the
    vectorized star stitch — see :func:`_stitch_components_star`)."""
    labels = _component_labels(n, senders, receivers)
    ea, eb = _stitch_components_star(labels, rng)
    if ea.size == 0:
        return senders, receivers
    return (np.concatenate([senders.astype(np.int64),
                            np.minimum(ea, eb)]),
            np.concatenate([receivers.astype(np.int64),
                            np.maximum(ea, eb)]))


def _dedupe_pairs(senders: np.ndarray, targets: np.ndarray):
    """Canonicalize to unique undirected pairs (s < r), dropping loops."""
    keep = senders != targets
    a = np.minimum(senders[keep], targets[keep]).astype(np.int64)
    b = np.maximum(senders[keep], targets[keep]).astype(np.int64)
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def random_degree_graph(n: int, seed, dmin: int = 3, dmax: int = 6) -> np.ndarray:
    """Each node connects to d ~ U{dmin..dmax} random distinct others (§5.1)."""
    rng = _rng(seed)
    adj = _empty(n)
    for i in range(n):
        d = rng.integers(dmin, dmax + 1)
        targets = rng.choice(n - 1, size=d, replace=False)
        targets = targets + (targets >= i)  # skip self
        adj[i, targets] = 1.0
        adj[targets, i] = 1.0
    return _ensure_connected(adj, rng)


def _distinct_targets(rng: np.random.Generator, senders: np.ndarray,
                      n: int) -> np.ndarray:
    """One distinct non-self target per (sender, slot) row, vectorized:
    draw all rows at once, then redraw only within-sender duplicates
    until none remain (rejection sampling — exactly the uniform
    distinct-subset distribution of ``rng.choice(replace=False)``,
    without the per-node Python loop).  Terminates a.s. for per-sender
    slot counts < n; expected a couple of rounds at d ≪ n."""
    t = rng.integers(0, n - 1, size=senders.size)
    t += t >= senders                           # skip self
    for _ in range(10_000):
        order = np.lexsort((t, senders))
        s_s, t_s = senders[order], t[order]
        dup = (s_s[1:] == s_s[:-1]) & (t_s[1:] == t_s[:-1])
        dup_idx = order[1:][dup]
        if dup_idx.size == 0:
            return t
        fresh = rng.integers(0, n - 1, size=dup_idx.size)
        t[dup_idx] = fresh + (fresh >= senders[dup_idx])
    raise RuntimeError("duplicate-target rejection failed to converge "
                       "(per-node degree too close to n?)")


def random_degree_graph_edges(n: int, seed, dmin: int = 3, dmax: int = 6):
    """Edge-list §5.1 model: vectorized over all nodes (no Python-per-node
    loop, no (N, N) array), viable at N=10^5–10^6.

    Each node draws d ~ U{dmin..dmax} DISTINCT uniform targets (same
    per-node distribution as the dense twin's ``replace=False`` draws,
    realized by vectorized rejection of within-node duplicates), so the
    dense generator's degree >= dmin guarantee holds here too.  Returns
    undirected pairs ``(senders, receivers)`` with s < r, connected
    (stitched like every other generator).
    """
    rng = _rng(seed)
    d = np.minimum(rng.integers(dmin, dmax + 1, size=n), n - 1)
    senders = np.repeat(np.arange(n, dtype=np.int64), d)
    targets = _distinct_targets(rng, senders, n)
    s, r = _dedupe_pairs(senders, targets)
    return _ensure_connected_edges(n, s, r, rng)


def preferential_attachment(n: int, seed, m: int = 2) -> np.ndarray:
    """Barabási–Albert: each new node attaches m edges ∝ current degree."""
    rng = _rng(seed)
    adj = _empty(n)
    seed_size = m + 1
    for i in range(seed_size):
        for j in range(i + 1, seed_size):
            adj[i, j] = adj[j, i] = 1.0
    degree = adj.sum(axis=1)
    for i in range(seed_size, n):
        probs = degree[:i] / degree[:i].sum()
        targets = rng.choice(i, size=min(m, i), replace=False, p=probs)
        adj[i, targets] = 1.0
        adj[targets, i] = 1.0
        degree[targets] += 1.0
        degree[i] = len(targets)
    return adj


def preferential_attachment_edges(n: int, seed, m: int = 2):
    """Edge-list Barabási–Albert via the repeated-endpoints trick: sampling
    an entry of the edge-endpoint multiset IS degree-proportional
    sampling, so attachment is O(1) per edge with no O(i) probability
    renormalization per node (the dense generator's bottleneck).
    Connected by construction.  Returns undirected (senders, receivers).
    """
    rng = _rng(seed)
    seed_size = m + 1
    s0, r0 = np.triu_indices(seed_size, k=1)
    num_edges = s0.size + (n - seed_size) * m
    sends = np.empty(num_edges, np.int64)
    recvs = np.empty(num_edges, np.int64)
    sends[:s0.size], recvs[:s0.size] = s0, r0
    # endpoint multiset: each edge contributes both endpoints
    endpoints = np.empty(2 * num_edges, np.int64)
    endpoints[:2 * s0.size:2] = s0
    endpoints[1:2 * s0.size:2] = r0
    ecount = 2 * s0.size
    ne = s0.size
    for i in range(seed_size, n):
        take = min(m, i)
        # degree-proportional distinct targets: redraw until distinct
        cand = endpoints[rng.integers(0, ecount, size=take)]
        while np.unique(cand).size < take:
            cand = endpoints[rng.integers(0, ecount, size=take)]
        sends[ne:ne + take] = i
        recvs[ne:ne + take] = cand
        endpoints[ecount:ecount + 2 * take:2] = i
        endpoints[ecount + 1:ecount + 2 * take:2] = cand
        ecount += 2 * take
        ne += take
    return np.minimum(sends[:ne], recvs[:ne]), \
        np.maximum(sends[:ne], recvs[:ne])


def specialized_geometric(n: int, seed, links_per_node: int = 3,
                          neighborhood: int = 15) -> np.ndarray:
    """§6 geometric model: nodes in the unit square; each node randomly links
    to ``links_per_node`` nodes from its ``neighborhood`` nearest (L2)."""
    rng = _rng(seed)
    coords = rng.random((n, 2)).astype(np.float32)
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    adj = _empty(n)
    for i in range(n):
        near = np.argsort(d2[i])[:neighborhood]
        chosen = rng.choice(near, size=min(links_per_node, near.size),
                            replace=False)
        adj[i, chosen] = 1.0
        adj[chosen, i] = 1.0
    return _ensure_connected(adj, rng)


def specialized_geometric_edges(n: int, seed, links_per_node: int = 3,
                                neighborhood: int = 15):
    """Edge-list §6 geometric model: k-nearest neighbors via a KD-tree
    (O(N log N)) instead of the dense generator's O(N^2) distance matrix;
    each node links to ``links_per_node`` uniform distinct picks among its
    ``neighborhood`` nearest.  Returns undirected (senders, receivers),
    connected.
    """
    from scipy.spatial import cKDTree   # scipy ships with jax

    rng = _rng(seed)
    n_eff = min(neighborhood, n - 1)
    links = min(links_per_node, n_eff)
    coords = rng.random((n, 2)).astype(np.float32)
    _, near = cKDTree(coords).query(coords, k=n_eff + 1)
    near = near[:, 1:]                               # drop self
    # uniform distinct subset per row: argpartition of random keys
    keys = rng.random((n, n_eff))
    pick = np.argpartition(keys, links - 1, axis=1)[:, :links]
    targets = np.take_along_axis(near, pick, axis=1).ravel()
    senders = np.repeat(np.arange(n, dtype=np.int64), links)
    s, r = _dedupe_pairs(senders, targets)
    return _ensure_connected_edges(n, s, r, rng)


def erdos_renyi(n: int, p: float, seed) -> np.ndarray:
    """G(n, p).  Routed through :func:`_ensure_connected` like every other
    generator: small-p draws are disconnected with high probability, and
    the paper's §3 assumptions (BFS initial partitioning, Thm A.1 growth)
    exclude disconnected graphs — previously this was the ONE generator
    that skipped stitching and silently handed the game stranded
    components."""
    rng = _rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, k=1).astype(np.float32)
    return _ensure_connected(adj + adj.T, rng)


def erdos_renyi_edges(n: int, p: float, seed):
    """Edge-list G(n, p): draw Binomial(C(n,2), p) for the edge count, then
    that many uniform distinct pairs — the standard G(n, M)-style
    construction of G(n, p), O(E) memory.  Connected (stitched).
    Returns undirected (senders, receivers)."""
    rng = _rng(seed)
    total = n * (n - 1) // 2
    m = int(rng.binomial(total, p)) if total else 0
    s = np.empty(0, np.int64)
    r = np.empty(0, np.int64)
    while s.size < m:
        draw = max(2 * (m - s.size), 16)
        cs = rng.integers(0, n, size=draw)
        cr = rng.integers(0, n, size=draw)
        s, r = _dedupe_pairs(np.concatenate([s, cs]), np.concatenate([r, cr]))
    if s.size > m:
        keep = rng.choice(s.size, size=m, replace=False)
        keep.sort()
        s, r = s[keep], r[keep]
    return _ensure_connected_edges(n, s, r, rng)


def random_weights(adj: np.ndarray, seed, mean: float = 5.0):
    """Node and edge weights with the §5.1 distribution (mean ``mean``).

    The paper says only "randomly generated ... with mean 5"; we use
    U(0, 2*mean), a deviation documented in DESIGN.md §8.
    Returns (node_weights (N,), weighted_adjacency (N, N)).
    """
    rng = _rng(seed)
    n = adj.shape[0]
    node_w = rng.uniform(0.0, 2.0 * mean, size=n).astype(np.float32)
    edge_w = rng.uniform(0.0, 2.0 * mean, size=(n, n)).astype(np.float32)
    edge_w = np.triu(edge_w, 1)
    edge_w = edge_w + edge_w.T
    return node_w, (edge_w * (adj > 0)).astype(np.float32)


def random_weights_edges(n: int, senders: np.ndarray, seed,
                         mean: float = 5.0):
    """Edge-list twin of :func:`random_weights`: per-node and per-edge
    U(0, 2*mean) weights (DESIGN.md §8) without the (N, N) draw.
    Returns (node_weights (N,), edge_weights (E,)) aligned with the
    undirected pair list."""
    rng = _rng(seed)
    node_w = rng.uniform(0.0, 2.0 * mean, size=n).astype(np.float32)
    edge_w = rng.uniform(0.0, 2.0 * mean,
                         size=np.asarray(senders).shape[0]).astype(np.float32)
    return node_w, edge_w
