"""Persistent aggregate state for incremental refinement (DESIGN.md §10),
PyTorch port of ``repro.core.aggregate`` (dense arms).

A turn's decision needs only aggregate state: the (N, K) adjacency
aggregate A[i, k] = sum_j c_ij 1[r_j = k], the O(K) load vector and the
global potentials.  The refinement loop carries all of it:

  * a move of node l from machine s to d is a rank-1 column update
        A[:, s] -= c[:, l]        A[:, d] += c[:, l]
  * the loads update is a two-entry delta;
  * both potentials update by the exact-potential identities
    (Thm. 3.1: ΔC_0 = 2 ΔC_l;  Thm. 5.1: ΔCt_0 = ΔCt_l), read off the
    moved node's O(K) cost rows.

States are never updated in place: every update returns new tensors, so a
checkpoint (:mod:`repro_torch.core.checkpoint`) may alias a state safely.
Gates (``do_move``) are device booleans, so a turn never waits on the
card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import costs
from .problem import as_assignment, machine_loads


class AggregateState(NamedTuple):
    """Everything a refinement turn needs, carried through the loop."""
    assignment: torch.Tensor   # (N,) int32
    loads: torch.Tensor        # (K,) float32 — L_k = sum of owned b
    aggregate: torch.Tensor    # (N, K) float32 — A[i, k]
    c0: torch.Tensor           # () float32 — C_0(assignment)
    ct0: torch.Tensor          # () float32 — Ct_0(assignment)


def _index(x, device) -> torch.Tensor:
    """A (1,) int64 index tensor; device tensors stay on the device and a
    Python int is filled in place, so neither copies from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(1)
    return torch.full((1,), int(x), dtype=torch.int64, device=device)


def _flag(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool).reshape(())
    return torch.full((), bool(x), dtype=torch.bool, device=device)


def init_aggregate_state(problem, assignment) -> AggregateState:
    """Build the carry from scratch: one O(N^2 K) aggregate product and one
    O(N^2) pass per potential — paid once."""
    costs.require_dense(problem)
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
    (1,) index tensor) via the exact-potential identities — O(K)."""
    c_row, ct_row = node_cost_rows(agg_row, b_node, source, loads, speeds,
                                   mu, total_weight)
    d, s = dest[:, None], source[:, None]
    dc0 = 2.0 * (c_row.gather(1, d) - c_row.gather(1, s))
    dct0 = ct_row.gather(1, d) - ct_row.gather(1, s)
    return dc0.reshape(()), dct0.reshape(())


def apply_move(problem, agg: AggregateState, node, source, dest, do_move,
               total_weight) -> AggregateState:
    """Apply one (gated) unilateral move: rank-1 aggregate update, O(1)
    load delta, O(K) potential deltas via the exact identities.

    The rank-1 update is the outer product of column l with the ``±1``
    one-hot column delta, zeroed when ``do_move`` is false: the untouched
    columns (and a rejected move) add an exact ``+0.0``, so the values are
    bitwise those of the reference's gated update.
    """
    costs.require_dense(problem)
    dev = problem.device
    k = agg.loads.shape[0]
    # a NaN-poisoned row reports best machine K and never moves; clamp so
    # the discarded gathers stay in range (the reference's gathers clamp)
    node, source, dest = (_index(node, dev), _index(source, dev),
                          _index(dest, dev).clamp(max=k - 1))
    do_move = _flag(do_move, dev)
    b_node = problem.node_weights.index_select(0, node)        # (1,)
    agg_row = agg.aggregate.index_select(0, node)               # (1, K)
    dc0, dct0 = potential_deltas(agg_row, b_node, source, dest, agg.loads,
                                 problem.speeds, problem.mu, total_weight)
    dt = agg.aggregate.dtype
    kidx = torch.arange(k, device=dev)
    col_delta = (kidx == dest).to(dt) - (kidx == source).to(dt)
    col_delta = torch.where(do_move, col_delta, 0.0)
    col = problem.adjacency.index_select(0, node)[0]   # symmetric: row l
    aggregate = agg.aggregate + col[:, None] * col_delta[None, :]
    loads = agg.loads + b_node * col_delta
    moved_to = torch.where(do_move, dest.to(torch.int32),
                           agg.assignment.index_select(0, node))
    assignment = agg.assignment.scatter(0, node, moved_to)
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


def apply_sweep(problem, agg: AggregateState, picks, dests, will_move,
                total_weight) -> AggregateState:
    """Apply a §4.5 sweep: machine m moves node picks[m] (owned by m) to
    dests[m] wherever will_move[m] — a rank-K aggregate update, then both
    potentials via the (loads, sq_loads, cut) closed forms.

    Duplicate destinations are summed in machine order, one column add at
    a time, as the reference's scatter-add sums them — a fixed order with
    no atomics.  Idle machines' picks may be garbage; their columns are
    zeroed and their assignment writes dropped.
    """
    costs.require_dense(problem)
    k = problem.num_machines
    b = problem.node_weights
    dev = problem.device
    dt = agg.aggregate.dtype
    picks = picks.long()
    mask = will_move.to(dt)                                    # (K,)
    cols = problem.adjacency.index_select(1, picks) * mask[None, :]
    aggregate = agg.aggregate - cols                           # sources 0..K-1
    kidx = torch.arange(k, device=dev)
    dest_hot = (dests.long()[:, None] == kidx[None, :]).to(dt)  # (K, K)
    for m in range(k):
        aggregate = aggregate + cols[:, m:m + 1] * dest_hot[m][None, :]
    nidx = torch.arange(problem.num_nodes, device=dev)
    hit = (nidx[None, :] == picks[:, None]) & will_move[:, None]   # (K, N)
    new_value = torch.sum(hit.to(torch.int32) * dests.to(torch.int32)[:, None],
                          dim=0).to(torch.int32)
    assignment = torch.where(hit.any(dim=0), new_value, agg.assignment)
    loads = machine_loads(b, assignment, k)
    sq_loads = machine_loads(b * b, assignment, k)
    cut = cut_from_aggregate(aggregate, assignment)
    c0, ct0 = potentials_closed_form(loads, sq_loads, cut, problem.speeds,
                                     problem.mu, total_weight)
    return AggregateState(assignment=assignment, loads=loads,
                          aggregate=aggregate, c0=c0, ct0=ct0)


def rebuild_state(problem, assignment, total_weight) -> AggregateState:
    """A fresh :class:`AggregateState` with closed-form potentials."""
    costs.require_dense(problem)
    assignment = as_assignment(assignment, problem.device)
    k = problem.num_machines
    b = problem.node_weights
    aggregate = costs.problem_aggregate(problem, assignment, k)
    loads = machine_loads(b, assignment, k)
    sq_loads = machine_loads(b * b, assignment, k)
    cut = cut_from_aggregate(aggregate, assignment)
    c0, ct0 = potentials_closed_form(loads, sq_loads, cut, problem.speeds,
                                     problem.mu, total_weight)
    return AggregateState(assignment=assignment, loads=loads,
                          aggregate=aggregate, c0=c0, ct0=ct0)


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
