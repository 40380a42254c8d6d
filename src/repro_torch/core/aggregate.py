"""Persistent aggregate state for incremental refinement (DESIGN.md §10),
PyTorch port of ``repro.core.aggregate``.

A turn's decision needs only aggregate state: the (N, K) adjacency
aggregate A[i, k] = sum_j c_ij 1[r_j = k], the O(K) load vector and the
global potentials.  The refinement loop carries all of it:

  * a move of node l from machine s to d is a rank-1 column update
        A[:, s] -= c[:, l]        A[:, d] += c[:, l]
  * the loads update is a two-entry delta;
  * both potentials update by the exact-potential identities
    (Thm. 3.1: ΔC_0 = 2 ΔC_l;  Thm. 5.1: ΔCt_0 = ΔCt_l), read off the
    moved node's O(K) cost rows.

The carried (N, K) aggregate is the same for both representations; only
the update differs.  A dense move adds column l of the adjacency (O(N));
a sparse move (:class:`~repro_torch.core.sparse.SparseProblem`) adds the
moved node's ``max_degree`` window of incident edges (O(deg)), and R
simultaneous moves add R windows.  Window contributions to one row are
added one at a time in the reference's scatter order — window r
ascending, then slot d ascending — by :func:`add_windows`, never with
float atomics, so the carried values are bitwise the reference's.

States are never updated in place: every update returns new tensors, so a
checkpoint (:mod:`repro_torch.core.checkpoint`) may alias a state safely.
Gates (``do_move``) are device booleans, so a unilateral turn never waits
on the card; a multi-window update reads one count back (see
:func:`add_windows`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import costs
from .problem import as_assignment, machine_loads
from .sparse import node_incident_edges_batched, window_slots


class AggregateState(NamedTuple):
    """Everything a refinement turn needs, carried through the loop."""
    assignment: torch.Tensor   # (N,) int32
    loads: torch.Tensor        # (K,) float32 — L_k = sum of owned b
    aggregate: torch.Tensor    # (N, K) float32 — A[i, k]
    c0: torch.Tensor           # () float32 — C_0(assignment)
    ct0: torch.Tensor          # () float32 — Ct_0(assignment)


def _index(x, device, lead=()) -> torch.Tensor:
    """A (*lead, 1) int64 index tensor (one index per fleet element, or
    (1,)); device tensors stay on the device and a Python int is filled in
    place, so neither copies from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(*lead, 1)
    return torch.full((*lead, 1), int(x), dtype=torch.int64, device=device)


def _flag(x, device, shape=()) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool).reshape(shape)
    return torch.full(shape, bool(x), dtype=torch.bool, device=device)


def init_aggregate_state(problem, assignment) -> AggregateState:
    """Build the carry from scratch: one O(N^2 K) aggregate product and one
    O(N^2) pass per potential — paid once.  Sparse problems pay O(E K)
    + O(E) instead (window sums over the edge list, closed-form C_0)."""
    assignment = as_assignment(assignment, problem.device)
    k = problem.num_machines
    aggregate = costs.problem_aggregate(problem, assignment, k)
    loads = machine_loads(problem.node_weights, assignment, k)
    c0 = costs.global_cost_c0(problem, assignment)
    ct0 = costs.global_cost_ct0(problem, assignment)
    return AggregateState(assignment=assignment, loads=loads,
                          aggregate=aggregate, c0=c0, ct0=ct0)


def node_cost_rows(agg_row, b_node, source, loads, speeds, mu, total_weight):
    """Both frameworks' (1, K) cost rows of one node from its (1, K)
    aggregate row, through :func:`costs.cost_matrix_from_aggregate` so the
    numbers are those of the full cost matrix.  ``source`` is the node's
    current machine as a (1,) tensor."""
    c_row = costs.cost_matrix_from_aggregate(
        agg_row, source, b_node, loads, speeds, mu, costs.C_FRAMEWORK,
        total_weight=total_weight)
    ct_row = costs.cost_matrix_from_aggregate(
        agg_row, source, b_node, loads, speeds, mu, costs.CT_FRAMEWORK,
        total_weight=total_weight)
    return c_row, ct_row


def potential_deltas(agg_row, b_node, source, dest, loads, speeds, mu,
                     total_weight):
    """(ΔC_0, ΔCt_0) of moving one node from ``source`` to ``dest`` (each a
    (1,) index tensor) via the exact-potential identities — O(K).  A
    fleet passes (B, 1) indices, (B, 1, K) rows and (B,) scalars and gets
    (B,) deltas."""
    c_row, ct_row = node_cost_rows(agg_row, b_node, source, loads, speeds,
                                   mu, total_weight)
    d, s = dest[..., None], source[..., None]
    dc0 = 2.0 * (c_row.gather(-1, d) - c_row.gather(-1, s))
    dct0 = ct_row.gather(-1, d) - ct_row.gather(-1, s)
    return dc0.reshape(dest.shape[:-1]), dct0.reshape(dest.shape[:-1])


def add_windows(aggregate, targets, contrib, rounds: int | None = None):
    """``aggregate`` with ``contrib[m]`` added to row ``targets[m]`` for
    every m, one addition at a time in ascending m, as the reference's
    sequential scatter-add does — without float atomics.

    Zero contributions are identities (an aggregate entry is never -0.0)
    and go to a scratch row.  The others are grouped by target, order
    kept (a stable sort), and applied in rounds: round j adds each
    target's j-th contribution, so no two writes of a round share a row.
    ``rounds`` bounds the deepest group; when it is None the depth is
    read back from the device (one host sync).  Returns a new tensor.
    """
    n, k = aggregate.shape
    nonzero = (contrib != 0).any(dim=1)
    t = torch.where(nonzero, targets.long(), n)
    t_sorted, order = torch.sort(t, stable=True)
    c_sorted = contrib.index_select(0, order)
    rank = torch.arange(t.shape[0], device=t.device) \
        - torch.searchsorted(t_sorted, t_sorted)
    if rounds is None:
        # host sync: the most nonzero contributions any one row receives
        rounds = int(torch.where(t_sorted < n, rank + 1, 0).max()) \
            if t.shape[0] else 0
    out = torch.cat([aggregate, aggregate.new_zeros((1, k))])
    for j in range(rounds):
        row = torch.where(rank == j, t_sorted, n)
        out[row] = out.index_select(0, row) + c_sorted
    return out[:n]


def apply_move(problem, agg: AggregateState, node, source, dest, do_move,
               total_weight) -> AggregateState:
    """Apply one (gated) unilateral move: rank-1 aggregate update, O(1)
    load delta, O(K) potential deltas via the exact identities.

    Dense: the rank-1 update is the outer product of column l with the
    ``±1`` one-hot column delta, zeroed when ``do_move`` is false: the
    untouched columns (and a rejected move) add an exact ``+0.0``, so the
    values are bitwise those of the reference's gated update.  Sparse
    (DESIGN.md §13.2): only the moved node's incident-edge window is
    added; its real edges have distinct receivers, so each row gets at
    most one nonzero contribution and one round of :func:`add_windows`
    applies it without reading anything back.

    A fleet (DESIGN.md §12) passes a stacked problem, a carry with a
    leading B axis (aggregate (B, N, K)), (B, 1) ``node``/``dest``, (B,)
    ``do_move``/``total_weight``, and element b moves ``node[b]``: every
    op is the unbatched one with a batch axis, so each element is bitwise
    its own move.  Dense, that gathers row ``node[b]`` of element b's
    adjacency — nothing of size B·N·N besides the stack itself.  Sparse,
    the aggregate is viewed as (B·N, K) with element b's receivers offset
    by b·N, so one round of :func:`add_windows` applies all B windows:
    windows of different elements never share a row (padding and foreign
    slots carry weight 0 and go to the scratch row).
    """
    *lead, n, k = agg.aggregate.shape
    dev = agg.aggregate.device
    # a NaN-poisoned row reports best machine K and never moves; clamp so
    # the discarded gathers stay in range (the reference's gathers clamp)
    node, source, dest = (_index(node, dev, lead), _index(source, dev, lead),
                          _index(dest, dev, lead).clamp(max=k - 1))
    do_move = _flag(do_move, dev, lead)
    b_node = problem.node_weights.gather(-1, node)              # (..., 1)
    agg_row = agg.aggregate.gather(-2, node[..., None].expand(*lead, 1, k))
    dc0, dct0 = potential_deltas(agg_row, b_node, source, dest, agg.loads,
                                 problem.speeds, problem.mu, total_weight)
    dt = agg.aggregate.dtype
    kidx = torch.arange(k, device=dev)
    col_delta = (kidx == dest).to(dt) - (kidx == source).to(dt)  # (..., K)
    col_delta = torch.where(do_move[..., None], col_delta, 0.0)
    if costs.is_sparse(problem):
        nbrs, w = node_incident_edges_batched(problem, node)  # (..., 1, D)
        rows = nbrs[..., 0, :]
        if lead:
            rows = rows + n * torch.arange(lead[0], device=dev)[:, None]
        contrib = w[..., 0, :, None] * col_delta[..., None, :]  # (..., D, K)
        aggregate = add_windows(agg.aggregate.reshape(-1, k),
                                rows.reshape(-1), contrib.reshape(-1, k),
                                rounds=1).reshape(agg.aggregate.shape)
    else:
        col = problem.adjacency.gather(
            -2, node[..., None].expand(*lead, 1, n))[..., 0, :]  # symmetric
        aggregate = agg.aggregate + col[..., :, None] * col_delta[..., None, :]
    loads = agg.loads + b_node * col_delta
    moved_to = torch.where(do_move[..., None], dest.to(torch.int32),
                           agg.assignment.gather(-1, node))
    assignment = agg.assignment.scatter(-1, node, moved_to)
    return AggregateState(
        assignment=assignment, loads=loads, aggregate=aggregate,
        c0=torch.where(do_move, agg.c0 + dc0, agg.c0),
        ct0=torch.where(do_move, agg.ct0 + dct0, agg.ct0))


# ---------------------------------------------------------------------------
# §4.5 simultaneous sweeps: rank-K update + O(K) closed-form potentials
# ---------------------------------------------------------------------------

def cut_from_aggregate(aggregate, assignment) -> torch.Tensor:
    """Invariant I4: unordered cut = 0.5 (sum_i degree_i - sum_i A[i, r_i])."""
    degree = costs.row_sum(aggregate)[:, 0]
    internal = aggregate.gather(1, assignment.long()[:, None])[:, 0]
    return 0.5 * (torch.sum(degree) - torch.sum(internal))


potentials_closed_form = costs.potentials_closed_form


def _set_assignment(assignment, nodes, dests, will_move):
    """``assignment`` with ``nodes[r]`` set to ``dests[r]`` where
    ``will_move[r]``; masked writes go to a scratch slot and are dropped
    (the reference's ``mode="drop"``).  Real movers are distinct nodes."""
    n = assignment.shape[0]
    safe = torch.where(will_move, nodes.long(), n)
    out = torch.cat([assignment, assignment.new_zeros(1)])
    out[safe] = dests.to(assignment.dtype)
    return out[:n]


def _closed_form_state(problem, aggregate, assignment, total_weight):
    """The state after a simultaneous update: loads and both potentials
    re-derived via the (loads, sq_loads, cut) closed forms."""
    k = problem.num_machines
    b = problem.node_weights
    loads = machine_loads(b, assignment, k)
    sq_loads = machine_loads(b * b, assignment, k)
    cut = cut_from_aggregate(aggregate, assignment)
    c0, ct0 = potentials_closed_form(loads, sq_loads, cut, problem.speeds,
                                     problem.mu, total_weight)
    return AggregateState(assignment=assignment, loads=loads,
                          aggregate=aggregate, c0=c0, ct0=ct0)


def _add_moved_windows(problem, aggregate, nodes, col_delta, mask):
    """Sparse rank-R update: the R moved nodes' incident-edge windows,
    masked by ``mask``, times their (R, K) column deltas, added in the
    reference's (r, d) scatter order."""
    nbrs, ws = node_incident_edges_batched(problem, nodes)    # (R, Dmax)
    ws = ws * mask[:, None]
    contrib = ws[:, :, None] * col_delta[:, None, :]          # (R, Dmax, K)
    return add_windows(aggregate, nbrs.reshape(-1),
                       contrib.reshape(-1, col_delta.shape[1]))


def apply_sweep(problem, agg: AggregateState, picks, dests, will_move,
                total_weight) -> AggregateState:
    """Apply a §4.5 sweep: machine m moves node picks[m] (owned by m) to
    dests[m] wherever will_move[m] — a rank-K aggregate update, then both
    potentials via the (loads, sq_loads, cut) closed forms.

    Dense: duplicate destinations are summed in machine order, one column
    add at a time, as the reference's scatter-add sums them.  Sparse: the
    K moved nodes' incident-edge windows (O(K·max_degree)).  Idle
    machines' picks may be garbage; their contributions are zeroed and
    their assignment writes dropped.
    """
    k = problem.num_machines
    dev = problem.device
    dt = agg.aggregate.dtype
    picks = picks.long()
    mask = will_move.to(dt)                                    # (K,)
    kidx = torch.arange(k, device=dev)
    dest_hot = (dests.long()[:, None] == kidx[None, :]).to(dt)  # (K, K)
    if costs.is_sparse(problem):
        # sources are exactly 0..K-1 (machine m moves an m-owned node)
        col_delta = dest_hot - (kidx[None, :] == kidx[:, None]).to(dt)
        aggregate = _add_moved_windows(problem, agg.aggregate, picks,
                                       col_delta, mask)
    else:
        cols = problem.adjacency.index_select(1, picks) * mask[None, :]
        aggregate = agg.aggregate - cols                       # sources
        for m in range(k):
            aggregate = aggregate + cols[:, m:m + 1] * dest_hot[m][None, :]
    assignment = _set_assignment(agg.assignment, picks, dests, will_move)
    return _closed_form_state(problem, aggregate, assignment, total_weight)


def apply_moves(problem, agg: AggregateState, nodes, dests, will_move,
                total_weight) -> AggregateState:
    """Apply up to R simultaneous moves (DESIGN.md §17): node ``nodes[r]``
    migrates to ``dests[r]`` wherever ``will_move[r]`` — a rank-R
    aggregate update, then both potentials via the closed forms, as in
    :func:`apply_sweep`, but with sources read from the carried
    assignment, so R is free.  Masked slots contribute an exact ``±0.0``
    and their assignment writes are dropped.

    Sparse problems add the R moved nodes' incident-edge windows
    (O(R·max_degree·K)); dense ones one (N, R) @ (R, K) product of the
    gathered adjacency columns against the ``±1`` column deltas.
    """
    k = problem.num_machines
    dt = agg.aggregate.dtype
    nodes = nodes.long()
    mask = will_move.to(dt)                                    # (R,)
    sources = agg.assignment.index_select(0, nodes).long()
    kidx = torch.arange(k, device=problem.device)
    col_delta = (dests.long()[:, None] == kidx[None, :]).to(dt) \
        - (sources[:, None] == kidx[None, :]).to(dt)          # (R, K)
    if costs.is_sparse(problem):
        aggregate = _add_moved_windows(problem, agg.aggregate, nodes,
                                       col_delta, mask)
    else:
        cols = problem.adjacency.index_select(1, nodes) * mask[None, :]
        aggregate = agg.aggregate + cols @ col_delta
    assignment = _set_assignment(agg.assignment, nodes, dests, will_move)
    return _closed_form_state(problem, aggregate, assignment, total_weight)


def apply_cluster_move(problem, agg: AggregateState, mask, source, dest,
                       do_move, total_weight) -> AggregateState:
    """Apply a §7 cluster move: every node in the boolean ``mask`` (all
    owned by ``source``) migrates jointly to ``dest`` when ``do_move``.

    For every node i, ``delta_i = sum_{j in cluster} c_ij`` moves from
    column ``source`` to column ``dest``: an O(E) masked sum over each
    row's edges in edge order on sparse problems, an O(N^2) masked
    matvec on dense ones.  Potentials come from the closed forms (a
    cluster move is not unilateral).
    """
    k = problem.num_machines
    dev = problem.device
    dt = agg.aggregate.dtype
    if costs.is_sparse(problem):
        delta = torch.zeros(problem.num_nodes, dtype=dt, device=dev)
        for e, own in window_slots(problem):
            hit = own & mask.index_select(
                0, problem.receivers.index_select(0, e).long())
            delta = delta + torch.where(
                hit, problem.edge_weights.index_select(0, e), 0.0)
    else:
        delta = problem.adjacency @ mask.to(dt)                # (N,)
    kidx = torch.arange(k, device=dev)
    source = torch.as_tensor(source, device=dev)
    dest = torch.as_tensor(dest, device=dev)
    col_delta = (kidx == dest).to(dt) - (kidx == source).to(dt)
    aggregate = agg.aggregate + delta[:, None] * col_delta[None, :]
    assignment = torch.where(mask, dest.to(torch.int32), agg.assignment)
    new = _closed_form_state(problem, aggregate, assignment, total_weight)
    do_move = _flag(do_move, dev)
    return AggregateState(*(torch.where(do_move, n_, o)
                            for n_, o in zip(new, agg)))


def rebuild_state(problem, assignment, total_weight) -> AggregateState:
    """A fresh :class:`AggregateState` with closed-form potentials:
    O(E·K) + O(K) on sparse problems.  The overflow path of the unbounded
    sweep mode (DESIGN.md §17): cheaper than a mover buffer of O(N)
    windows and drift-free by construction."""
    assignment = as_assignment(assignment, problem.device)
    aggregate = costs.problem_aggregate(problem, assignment,
                                        problem.num_machines)
    return _closed_form_state(problem, aggregate, assignment, total_weight)


# ---------------------------------------------------------------------------
# verify_every cross-check and repair
# ---------------------------------------------------------------------------

def resync(problem, agg: AggregateState):
    """Rebuild the carry from scratch, returning (fresh state, observed
    drift): the max absolute deviation of any carried quantity."""
    fresh = init_aggregate_state(problem, agg.assignment)
    observed = torch.maximum(
        torch.max(torch.abs(agg.aggregate - fresh.aggregate)),
        torch.maximum(
            torch.max(torch.abs(agg.loads - fresh.loads)),
            torch.maximum(torch.abs(agg.c0 - fresh.c0),
                          torch.abs(agg.ct0 - fresh.ct0))))
    return fresh, observed


def drift(problem, agg: AggregateState) -> torch.Tensor:
    """Max absolute deviation of the carried state from a rebuild."""
    return resync(problem, agg)[1]


def _inf_dev(x):
    return torch.nan_to_num(x, nan=float("inf"), posinf=float("inf"))


def repair_columns(problem, agg: AggregateState, tol: float):
    """Active repair (DESIGN.md §15.3): rebuild from scratch like
    :func:`resync`, but patch ONLY the quantities that deviate beyond
    ``tol`` — per machine column of the aggregate, per load entry, and per
    potential (relative).  Detection is NaN-safe (``~(dev <= tol)``).

    Returns ``(repaired, observed, cols)``.
    """
    fresh = init_aggregate_state(problem, agg.assignment)
    col_dev = torch.max(torch.abs(agg.aggregate - fresh.aggregate),
                        dim=0).values                          # (K,)
    col_bad = ~(col_dev <= tol)
    aggregate = torch.where(col_bad[None, :], fresh.aggregate, agg.aggregate)

    load_dev = torch.abs(agg.loads - fresh.loads)
    load_bad = ~(load_dev <= tol)
    loads = torch.where(load_bad, fresh.loads, agg.loads)

    def patch_scalar(live, fresh_value):
        dev = torch.abs(live - fresh_value)
        bad = ~(dev <= tol * torch.clamp(torch.abs(fresh_value), min=1.0))
        return torch.where(bad, fresh_value, live), _inf_dev(dev)

    c0, c0_dev = patch_scalar(agg.c0, fresh.c0)
    ct0, ct0_dev = patch_scalar(agg.ct0, fresh.ct0)
    observed = torch.maximum(
        torch.max(_inf_dev(col_dev)),
        torch.maximum(torch.max(_inf_dev(load_dev)),
                      torch.maximum(c0_dev, ct0_dev)))
    repaired = AggregateState(assignment=agg.assignment, loads=loads,
                              aggregate=aggregate, c0=c0, ct0=ct0)
    return repaired, observed, torch.sum(col_bad.to(torch.int32))
