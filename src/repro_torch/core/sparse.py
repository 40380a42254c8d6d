"""Sparse edge-list problem representation (DESIGN.md §13), PyTorch port
of ``repro.core.sparse``.

The dense :class:`~repro_torch.core.problem.PartitionProblem` carries an
(N, N) adjacency, which caps it near N=50k on one card.
``SparseProblem`` is its sparse sibling: a padded, sender-sorted COO/CSR
edge list (every undirected edge stored in both directions) that costs,
aggregates, every refinement entry point and the edge-block kernels
consume directly, so an N=10^6 graph never materializes an O(N^2) array.

Layout (DESIGN.md §13.1):

  * ``senders`` / ``receivers`` / ``edge_weights`` — (E,) tensors of the
    DIRECTED edge list: each undirected edge {i, j} appears as (i, j)
    and (j, i) with the same weight, sorted by sender (receivers
    ascending within a sender), so node i's incident edges occupy the
    contiguous slab ``[row_start[i], row_start[i] + degree_i)``.
  * **Padding** — E is rounded up to a multiple of 128 with slots
    ``sender = N-1, receiver = 0, weight = 0.0``: sortedness is kept,
    every index stays in range, and a zero-weight edge adds an exact
    ``+0.0`` to every sum it touches.
  * ``row_start`` — (N,) first edge index per node (CSR offsets).
  * ``max_degree`` — static upper bound on any node's degree (rounded up
    to a multiple of 8).  A move touches only the moved node's
    ``max_degree``-slot window of incident edges.

The (N, K) aggregate stays dense: it is the paper's own O(NK) state.
Every sum over a node's edges runs slot by slot through the windows of
:func:`window_slots`, edge order ascending, with no atomics — the order
the reference's ``segment_sum`` sums in, so values are bitwise equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .problem import (PartitionProblem, ProblemValidationError, _f32,
                      make_problem, resolve_device)

EDGE_PAD_MULTIPLE = 128     # padded E is a multiple of this
DEGREE_PAD_MULTIPLE = 8     # static max_degree rounds up to this

# Declared asymptotic budgets for the sparse representation, consumed by
# the complexity analyzers (``repro_torch.analysis``, DESIGN.md §18).
# Sparse paths promise O(E + N*K) memory and work: at most linear in N
# (at fixed degree), linear in E (the degree sweep), linear in K.  A
# fitted N-exponent near 2 means some op materialized a dense
# (N, N)-shaped intermediate — exactly the regression the sparse path
# exists to prevent.
SPARSE_COMPLEXITY = {
    "mem": {"n": 1.0, "e": 1.0, "k": 1.0},
    "ops": {"n": 1.0, "e": 1.0, "k": 1.0},
}


@dataclasses.dataclass(frozen=True)
class SparseProblem:
    """Sparse partition-game problem: padded sender-sorted edge list.

    Same game as :class:`~repro_torch.core.problem.PartitionProblem`
    (node weights ``b_i``, machine speeds ``w_k``, cut weight ``mu``),
    with the graph as edges instead of an (N, N) matrix.  Every tensor
    lies on one device; ``max_degree`` is a Python int.
    """
    senders: torch.Tensor        # (E,) int32, sorted ascending; pad N-1
    receivers: torch.Tensor      # (E,) int32; padding 0
    edge_weights: torch.Tensor   # (E,) float32; padding 0.0
    row_start: torch.Tensor      # (N,) int32 CSR offsets
    node_weights: torch.Tensor   # (N,) float32
    speeds: torch.Tensor         # (K,) float32, sums to 1
    mu: torch.Tensor             # () float32
    max_degree: int

    @property
    def num_nodes(self) -> int:
        return self.node_weights.shape[0]

    @property
    def num_machines(self) -> int:
        return self.speeds.shape[0]

    @property
    def num_edges(self) -> int:
        """PADDED directed edge count (2x undirected + padding)."""
        return self.senders.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_weights.device

    def validate(self) -> None:
        """Raise :class:`ProblemValidationError` on malformed fields
        (DESIGN.md §15.7), with the reference's messages.  Reads the
        tensors back to the host once."""
        n, e = self.num_nodes, self.num_edges
        for name, arr in (("senders", self.senders),
                          ("receivers", self.receivers),
                          ("edge_weights", self.edge_weights)):
            if tuple(arr.shape) != (e,):
                raise ProblemValidationError(
                    f"{name} shape {tuple(arr.shape)} does not match "
                    f"padded edge count E={e}")
        if tuple(self.row_start.shape) != (n,):
            raise ProblemValidationError(
                f"row_start shape {tuple(self.row_start.shape)} does not "
                f"match N={n}")
        if self.speeds.ndim != 1:
            raise ProblemValidationError(
                f"speeds must be (K,); got shape {tuple(self.speeds.shape)}")
        if self.max_degree < 1:
            raise ProblemValidationError(
                f"max_degree must be >= 1; got {self.max_degree}")
        if e < self.max_degree:
            raise ProblemValidationError(
                f"padded edge count E={e} is smaller than "
                f"max_degree={self.max_degree} (the incident-edge window "
                "would run off the arrays)")
        s = self.senders.cpu().numpy()
        r = self.receivers.cpu().numpy()
        w = self.edge_weights.cpu().numpy()
        if np.isnan(w).any():
            raise ProblemValidationError("edge_weights contains NaN")
        if (w < 0).any():
            raise ProblemValidationError("edge_weights contains negative "
                                         "weights")
        if s.size and (s.min() < 0 or r.min() < 0
                       or max(s.max(), r.max()) >= n):
            raise ProblemValidationError(
                f"edge endpoints out of range [0, {n})")
        if np.any(np.diff(s) < 0):
            raise ProblemValidationError("senders must be sorted ascending "
                                         "(CSR slab layout)")
        rs = self.row_start.cpu().numpy()
        if np.any(np.diff(rs) < 0) or (rs.size and rs[0] != 0):
            raise ProblemValidationError(
                "row_start must be non-decreasing CSR offsets starting "
                "at 0")
        if rs.size and rs.max() > e:
            raise ProblemValidationError(
                f"row_start points past the edge arrays "
                f"(max {rs.max()} > E={e})")
        real = w != 0
        if real.any():
            idx = np.nonzero(real)[0]
            lo = rs[s[idx]]
            if (idx < lo).any() or (idx >= lo + self.max_degree).any():
                raise ProblemValidationError(
                    "row_start inconsistent with sender slabs: a real "
                    "edge lies outside its sender's "
                    "[row_start, row_start + max_degree) window")
        b = self.node_weights.cpu().numpy()
        if np.isnan(b).any() or (b < 0).any():
            raise ProblemValidationError("node_weights must be finite and "
                                         "non-negative")
        sp = self.speeds.cpu().numpy()
        if np.isnan(sp).any() or (sp <= 0).any():
            raise ProblemValidationError("speeds must be finite and "
                                         "positive")


def _round_up(x: int, multiple: int) -> int:
    return -(-max(x, 1) // multiple) * multiple


def make_sparse_problem(senders, receivers, edge_weights, node_weights,
                        speeds, mu: float = 8.0, *,
                        normalize_speeds: bool = True,
                        pad_edges_multiple: int = EDGE_PAD_MULTIPLE,
                        pad_degree_multiple: int = DEGREE_PAD_MULTIPLE,
                        device=None) -> SparseProblem:
    """Build a :class:`SparseProblem` from an UNDIRECTED edge list.

    Host-side numpy, as in the reference: self-loops are dropped,
    duplicate {i, j} entries have their weights summed, both directed
    orientations are emitted sorted by (sender, receiver) and padded
    per the DESIGN.md §13.1 rules.  The tensors then move to ``device``
    (``None`` means the card).
    """
    device = resolve_device(device)
    s = np.asarray(senders, np.int64).ravel()
    r = np.asarray(receivers, np.int64).ravel()
    w = np.asarray(edge_weights, np.float64).ravel()
    if not (s.shape == r.shape == w.shape):
        raise ProblemValidationError(
            f"edge arrays disagree: {s.shape}, {r.shape}, {w.shape}")
    node_weights = np.asarray(node_weights, np.float64).ravel()
    n = node_weights.shape[0]
    if s.size and (s.min() < 0 or r.min() < 0 or max(s.max(), r.max()) >= n):
        raise ProblemValidationError("edge endpoints out of range")

    keep = s != r                                    # no self loops
    a = np.minimum(s[keep], r[keep])
    b = np.maximum(s[keep], r[keep])
    w = w[keep]
    # canonicalize + sum duplicate undirected edges
    code = a * n + b
    order = np.argsort(code, kind="stable")
    code, w = code[order], w[order]
    uniq, first = np.unique(code, return_index=True)
    w = np.add.reduceat(w, first) if w.size else w
    a, b = uniq // n, uniq % n

    # both directions, sorted by (sender, receiver)
    ds = np.concatenate([a, b])
    dr = np.concatenate([b, a])
    dw = np.concatenate([w, w])
    order = np.lexsort((dr, ds))
    ds, dr, dw = ds[order], dr[order], dw[order]

    degree = np.bincount(ds, minlength=n)
    max_degree = _round_up(int(degree.max(initial=1)), pad_degree_multiple)
    e_pad = _round_up(max(ds.size, max_degree), pad_edges_multiple)
    row_start = np.zeros(n, np.int64)
    row_start[1:] = np.cumsum(degree)[:-1]

    pad = e_pad - ds.size
    ds = np.concatenate([ds, np.full(pad, n - 1)])
    dr = np.concatenate([dr, np.zeros(pad, np.int64)])
    dw = np.concatenate([dw, np.zeros(pad)])

    speeds = _f32(np.asarray(speeds, np.float64), device)
    if normalize_speeds:
        speeds = speeds / torch.sum(speeds)

    def i32(x):
        return torch.as_tensor(x.astype(np.int32), device=device)

    prob = SparseProblem(
        senders=i32(ds), receivers=i32(dr),
        edge_weights=torch.as_tensor(dw.astype(np.float32), device=device),
        row_start=i32(row_start),
        node_weights=torch.as_tensor(node_weights.astype(np.float32),
                                     device=device),
        speeds=speeds,
        mu=torch.tensor(mu, dtype=torch.float32, device=device),
        max_degree=max_degree)
    prob.validate()
    return prob


def sparse_from_dense(problem: PartitionProblem, **kwargs) -> SparseProblem:
    """Convert a dense problem to its sparse edge-list twin on the same
    device.  The dense adjacency is symmetric with zero diagonal, so its
    upper triangle lists each undirected edge once with its weight."""
    adj = problem.adjacency.cpu().numpy()
    iu, ju = np.nonzero(np.triu(adj, k=1))
    kwargs.setdefault("device", problem.device)
    return make_sparse_problem(
        iu, ju, adj[iu, ju], problem.node_weights.cpu().numpy(),
        problem.speeds.cpu().numpy(), float(problem.mu),
        normalize_speeds=False, **kwargs)


def dense_from_sparse(sp: SparseProblem) -> PartitionProblem:
    """Materialize the (N, N) adjacency — small-N tests and oracles only."""
    n = sp.num_nodes
    adj = np.zeros((n, n), np.float32)
    np.add.at(adj, (sp.senders.cpu().numpy(), sp.receivers.cpu().numpy()),
              sp.edge_weights.cpu().numpy())   # padding adds 0.0 at (N-1, 0)
    return make_problem(adj, sp.node_weights, sp.speeds, float(sp.mu),
                        normalize_speeds=False, device=sp.device)


def window_starts(sp: SparseProblem, nodes: torch.Tensor) -> torch.Tensor:
    """First edge index of each node's ``max_degree`` window, clamped so
    the window stays inside the arrays (the clamp of the reference's
    ``dynamic_slice``).  Returns int64.  A fleet's stacked problem takes
    (B, R) nodes, one row of picks per element."""
    last = sp.senders.shape[-1] - sp.max_degree
    return sp.row_start.gather(-1, nodes.long()).long().clamp(max=last)


def window_slots(sp: SparseProblem):
    """Walk every node's window one slot at a time: yields, for slot
    d = 0, 1, ..., max_degree-1, the (N,) edge index each node reads
    there and whether that edge is the node's own (sender == node).

    A node's own edges come up in ascending edge order, each once; every
    other slot is masked.  Sums built slot by slot therefore add each
    row's edges in the order of the reference's ``segment_sum``, and
    each step touches each row once, so no two writes collide."""
    nodes = torch.arange(sp.num_nodes, device=sp.device)
    start = window_starts(sp, nodes)
    for d in range(sp.max_degree):
        e = start + d
        yield e, sp.senders.index_select(0, e) == nodes


def frontier_expand(sp: SparseProblem, mask: torch.Tensor) -> torch.Tensor:
    """One BFS frontier step over the edge list: ``mask`` grown by every
    node adjacent (through a real, nonzero-weight edge) to a masked node
    — the O(E) replacement for the dense ``mask @ (adj > 0)`` step of
    :func:`repro_torch.core.cluster.h_hop_mask` (DESIGN.md §17.3)."""
    reached = torch.zeros_like(mask)
    for e, own in window_slots(sp):
        hit = mask.index_select(0, sp.receivers.index_select(0, e).long()) \
            & (sp.edge_weights.index_select(0, e) > 0) & own
        reached = reached | hit
    return mask | reached


def node_incident_edges(sp: SparseProblem, node
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(neighbors, weights) of one node as a ``max_degree`` window — the
    O(deg) replacement for the dense path's adjacency row.  Slots whose
    sender is not ``node`` (tail padding, the next node's edges, or
    spill-over where the window clamps at the array end) carry weight 0.
    """
    node = torch.as_tensor(node, device=sp.device).reshape(1)
    nbrs, w = node_incident_edges_batched(sp, node)
    return nbrs[0], w[0]


def node_incident_edges_batched(sp: SparseProblem, nodes: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`node_incident_edges` for (R,) nodes: (R, max_degree)
    neighbor and weight windows (the reference ``vmap``s the one-node
    form).  A fleet's stacked problem takes (B, R) nodes and gives
    (B, R, max_degree) windows, each from its own element's edges."""
    nodes = nodes.long()
    idx = window_starts(sp, nodes)[..., None] + torch.arange(
        sp.max_degree, device=sp.device)
    flat = idx.reshape(idx.shape[:-2] + (-1,))

    def take(x):
        return x.gather(-1, flat).reshape(idx.shape)

    s = take(sp.senders)
    return take(sp.receivers), torch.where(s == nodes[..., None],
                                           take(sp.edge_weights), 0.0)
