"""Iterative partition refinement (paper §4.2, Fig. 1/2), PyTorch port of
``repro.core.refine`` (dense problems).

Machines take sequential round-robin turns.  On its turn a machine finds
the most dissatisfied node it owns (Eq. 4) and transfers it to that
node's best-response machine; a node whose net dissatisfaction is not
above ``tol`` makes the machine forsake its turn.  Every transfer strictly
decreases the potential C_0 (Ct_0 for the second framework), so the game
converges (Thm. 4.1); convergence is declared after K consecutive
forsaken turns.

Entry points:
  * ``refine``              — loop until convergence (bounded by
                              ``max_turns``).
  * ``refine_traced``       — fixed-length loop recording per-turn moves
                              and both global potentials.
  * ``refine_simultaneous`` — the paper-§4.5 mode, one move per machine
                              per sweep.

Two cost paths (DESIGN.md §10): **incremental** (default) carries an
:class:`~repro_torch.core.aggregate.AggregateState`; **recompute** (also
selected by passing ``cost_matrix_fn``, e.g. the cost-matrix kernel)
rebuilds the (N, K) costs from the adjacency every turn.

The loops never wait on the card inside a turn: the move gate, the idle
count and the turn and move counts stay device tensors, turns after
convergence are masked inactive, and the host reads the convergence flag
once every ``_SYNC_EVERY`` turns (and at each ``verify_every`` or
``repair_every`` boundary).  ``num_turns`` counts only active turns, so it
equals the reference's count exactly.

The ``dissat_fn`` convention
----------------------------

Every pluggable per-turn reduction takes exactly 9 positionals::

    dissat_fn(aggregate, assignment, node_weights, loads, speeds, mu,
              framework, total_weight, theta) -> (dissat, best_machine)

1. ``aggregate``    — (rows, K) f32, ``A[i, k] = sum_j c_ij 1[r_j = k]``.
2. ``assignment``   — (rows,) i32, the rows' OWN current machines.
3. ``node_weights`` — (rows,) f32, the rows' loads ``b_i``.
4. ``loads``        — (K,) f32, GLOBAL machine loads ``L_k``.
5. ``speeds``       — (K,) f32, machine capacities ``w_k``.
6. ``mu``           — () f32, inter-machine cost weight (paper §3.1).
7. ``framework``    — str, ``"c"`` (Eq. 1) or ``"ct"`` (Eq. 6).
8. ``total_weight`` — () f32, the global weight sum ``B``.
9. ``theta``        — ``None`` or (rows,) f32 per-node migration price
   (DESIGN.md §11); the returned dissatisfaction is NET of it.

It returns the net Eq.-4 dissatisfaction and the LOWEST-INDEX arg-best
machine (DESIGN.md §7).  With ``dissat_fn=None`` the incremental path uses
:func:`repro_torch.kernels.ops.make_aggregate_dissat_fn` — the fused
kernel on the card, its plain twin on the CPU — whose ``current`` and
``best`` come from one cost value per machine, so a node on its best
machine has exactly zero dissatisfaction.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from ..kernels import ops
from . import aggregate as agg_mod
from . import checkpoint as ckpt_mod
from . import costs
from .problem import PartitionState, make_state

# Dissatisfaction below this threshold counts as "satisfied" — guards float
# round-off from keeping the loop alive on a plateau.
DEFAULT_TOL = 1e-6

# Turns between the host's reads of the convergence flag.
_SYNC_EVERY = 64


class DissatFn(Protocol):
    """THE canonical 9-argument ``dissat_fn`` convention (module docstring)."""

    def __call__(self, aggregate, assignment, node_weights, loads, speeds,
                 mu, framework: str, total_weight,
                 theta=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(dissat (rows,), best_machine (rows,))``."""
        ...


class TurnResult(NamedTuple):
    moved: torch.Tensor    # bool   — did this turn transfer a node?
    node: torch.Tensor     # int32  — the node transferred (or -1)
    source: torch.Tensor   # int32  — machine that owned it (or -1)
    dest: torch.Tensor     # int32  — machine it moved to (or -1)
    gain: torch.Tensor     # float  — net dissatisfaction of the moved node
    c0: torch.Tensor       # float  — C_0 after the turn (0 on recompute)
    ct0: torch.Tensor      # float  — Ct_0 after the turn (0 on recompute)


class RefineResult(NamedTuple):
    assignment: torch.Tensor    # (N,) final assignment
    loads: torch.Tensor         # (K,)
    num_moves: torch.Tensor     # int32 — total node transfers
    num_turns: torch.Tensor     # int32 — total machine turns taken
    converged: torch.Tensor     # bool
    # max deviation observed at verify_every/repair_every boundaries
    aggregate_drift: torch.Tensor | float = 0.0


class Trace(NamedTuple):
    """Per-turn record from ``refine_traced`` (fixed length = max_turns)."""
    moved: torch.Tensor    # (T,) bool
    node: torch.Tensor     # (T,) int32
    source: torch.Tensor   # (T,) int32
    dest: torch.Tensor     # (T,) int32
    gain: torch.Tensor     # (T,) float
    c0: torch.Tensor       # (T,) float — C_0 after each turn
    ct0: torch.Tensor      # (T,) float — Ct_0 after each turn
    active: torch.Tensor   # (T,) bool  — False once converged


def _no_recorder(recorder) -> None:
    if recorder is not None:
        raise NotImplementedError(
            "recorder= (run telemetry) is not ported yet; it comes with "
            "the telemetry slice of the port")


def _resolve_theta(theta, problem) -> torch.Tensor | None:
    """Normalize the hysteresis threshold to None or an (N,) f32 tensor."""
    if theta is None:
        return None
    if not isinstance(theta, torch.Tensor):
        theta = torch.as_tensor(np.asarray(theta, np.float32))
    theta = theta.to(device=problem.device, dtype=torch.float32)
    return theta.expand(problem.num_nodes).contiguous()


def _zero_i32(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _pick(dissat, assignment, machine: int, tol: float, active):
    """The machine's most dissatisfied owned node (first maximum) and
    whether it moves."""
    owned = assignment == machine
    masked = torch.where(owned, dissat, -float("inf"))
    node = torch.argmax(masked).reshape(1)
    gain = masked.index_select(0, node)[0]
    do_move = (gain > tol) & active
    return node, gain, do_move


def _result(do_move, node, machine: int, dest, gain, c0, ct0) -> TurnResult:
    node32 = node[0].to(torch.int32)
    return TurnResult(
        moved=do_move,
        node=torch.where(do_move, node32, -1),
        source=torch.where(do_move, node32.new_full((), machine), -1),
        dest=torch.where(do_move, dest[0].to(torch.int32), -1),
        gain=torch.where(do_move, gain, 0.0),
        c0=c0, ct0=ct0)


def _turn(problem, state: PartitionState, machine: int, framework: str,
          tol: float, cost_matrix_fn=None, theta=None, active=True):
    """One machine turn, recompute path: rebuild costs from scratch."""
    if cost_matrix_fn is None:
        cost = costs.cost_matrix(problem, state, framework)
    else:
        cost = cost_matrix_fn(problem, state, framework)
    dissat, best = costs.dissatisfaction(problem, state, framework,
                                         cost=cost, theta=theta)
    node, gain, do_move = _pick(dissat, state.assignment, machine, tol,
                                active)
    dest = best.index_select(0, node)
    moved_to = torch.where(do_move, dest,
                           state.assignment.index_select(0, node))
    new_assignment = state.assignment.scatter(0, node, moved_to)
    b_node = problem.node_weights.index_select(0, node)
    kidx = torch.arange(problem.num_machines, device=problem.device)
    delta = (kidx == dest).to(b_node.dtype) - (kidx == machine).to(
        b_node.dtype)
    new_loads = state.loads + b_node * torch.where(do_move, delta, 0.0)
    zero = torch.zeros((), device=problem.device)
    res = _result(do_move, node, machine, dest, gain, zero, zero)
    return PartitionState(new_assignment, new_loads), res


def _turn_incremental(problem, agg: agg_mod.AggregateState, machine: int,
                      framework: str, tol: float, total_b, dissat_fn,
                      theta=None, active=True):
    """One machine turn, incremental path: O(NK) costs from the carried
    aggregate, O(N) rank-1 move (DESIGN.md §10)."""
    dissat, best = dissat_fn(agg.aggregate, agg.assignment,
                             problem.node_weights, agg.loads, problem.speeds,
                             problem.mu, framework, total_b, theta)
    node, gain, do_move = _pick(dissat, agg.assignment, machine, tol, active)
    dest = best.index_select(0, node)
    new_agg = agg_mod.apply_move(problem, agg, node, machine, dest, do_move,
                                 total_b)
    return new_agg, _result(do_move, node, machine, dest, gain, new_agg.c0,
                            new_agg.ct0)


def refine(problem, assignment, framework: str = costs.C_FRAMEWORK,
           max_turns: int = 10_000, tol: float = DEFAULT_TOL,
           cost_matrix_fn=None, incremental: bool = True,
           verify_every: int = 0, repair_every: int = 0,
           dissat_fn: DissatFn | None = None, theta=None,
           recorder=None) -> RefineResult:
    """Run round-robin refinement to convergence (K consecutive idle turns).

    ``incremental=True`` (default) carries the aggregate state and reduces
    it each turn with ``dissat_fn`` (default: the fused kernel);
    ``cost_matrix_fn`` forces the recompute path.  ``verify_every=M > 0``
    rebuilds the carry every M turns and records the drift;
    ``repair_every=M > 0`` heals it every M turns (rollback over a
    non-finite carry, then column repair; DESIGN.md §15.3).  ``theta`` is
    the per-node migration price (DESIGN.md §11).
    """
    _no_recorder(recorder)
    costs.require_dense(problem)
    k = problem.num_machines
    dev = problem.device
    theta = _resolve_theta(theta, problem)
    if cost_matrix_fn is not None:
        incremental = False
    if incremental:
        if dissat_fn is None:
            dissat_fn = ops.make_aggregate_dissat_fn()
        carry = agg_mod.init_aggregate_state(problem, assignment)
        total_b = torch.sum(problem.node_weights)
        ckpt = ckpt_mod.take(carry, 0) if repair_every else None
    else:
        carry = make_state(problem, assignment)
    idle, turns, moves = _zero_i32(dev), _zero_i32(dev), _zero_i32(dev)
    max_drift = torch.zeros((), device=dev)

    for t in range(max_turns):
        if t and t % _SYNC_EVERY == 0 and not bool(idle < k):
            break
        active = idle < k
        if incremental:
            carry, res = _turn_incremental(problem, carry, t % k, framework,
                                           tol, total_b, dissat_fn, theta,
                                           active)
        else:
            carry, res = _turn(problem, carry, t % k, framework, tol,
                               cost_matrix_fn, theta, active)
        idle = torch.where(res.moved, 0, idle + 1)
        turns = turns + active.to(torch.int32)
        moves = moves + res.moved.to(torch.int32)
        done = t + 1
        if incremental and verify_every and done % verify_every == 0:
            if not bool(active):
                break
            carry, observed = agg_mod.resync(problem, carry)
            max_drift = torch.maximum(max_drift, observed)
        if incremental and repair_every and done % repair_every == 0:
            if not bool(active):
                break
            carry, observed, _cols, _rolled = ckpt_mod.heal(problem, carry,
                                                           ckpt)
            max_drift = torch.maximum(max_drift, observed)
            ckpt = ckpt_mod.take(carry, done)
    return RefineResult(assignment=carry.assignment, loads=carry.loads,
                        num_moves=moves, num_turns=turns,
                        converged=idle >= k, aggregate_drift=max_drift)


def refine_traced(problem, assignment, framework: str = costs.C_FRAMEWORK,
                  max_turns: int = 512, tol: float = DEFAULT_TOL,
                  incremental: bool = True, verify_every: int = 0,
                  theta=None, recorder=None):
    """Fixed-length variant recording both potentials after every turn.

    Returns ``(RefineResult, Trace)``.  Turns after convergence are no-ops
    with ``active=False``.  On the incremental path the recorded potentials
    are the carried values (exact-potential identities, no O(N^2) pass);
    on the recompute path they are evaluated from scratch each turn.  As in
    the reference, every one of the ``max_turns`` turns runs (masked once
    converged), and ``verify_every`` resyncs at every boundary.
    """
    _no_recorder(recorder)
    costs.require_dense(problem)
    k = problem.num_machines
    dev = problem.device
    theta = _resolve_theta(theta, problem)
    if incremental:
        carry = agg_mod.init_aggregate_state(problem, assignment)
        total_b = torch.sum(problem.node_weights)
    else:
        carry = make_state(problem, assignment)
    idle = _zero_i32(dev)
    max_drift = torch.zeros((), device=dev)
    rows = []
    for t in range(max_turns):
        active = idle < k
        if incremental:
            carry, res = _turn_incremental(problem, carry, t % k, framework,
                                           tol, total_b, _assembled_dissat,
                                           theta, active)
            c0, ct0 = carry.c0, carry.ct0
        else:
            carry, res = _turn(problem, carry, t % k, framework, tol,
                               theta=theta, active=active)
            c0 = costs.global_cost_c0(problem, carry.assignment)
            ct0 = costs.global_cost_ct0(problem, carry.assignment)
        idle = torch.where(res.moved, 0, idle + 1)
        if incremental and verify_every and (t + 1) % verify_every == 0:
            carry, observed = agg_mod.resync(problem, carry)
            max_drift = torch.maximum(max_drift, observed)
            c0, ct0 = carry.c0, carry.ct0
        rows.append((res.moved, res.node, res.source, res.dest, res.gain,
                     c0, ct0, active))
    trace = Trace(*(torch.stack(col) for col in zip(*rows)))
    result = RefineResult(
        assignment=carry.assignment, loads=carry.loads,
        num_moves=torch.sum(trace.moved.to(torch.int32)),
        num_turns=torch.sum(trace.active.to(torch.int32)),
        converged=idle >= k, aggregate_drift=max_drift)
    return result, trace


def _assembled_dissat(aggregate, assignment, node_weights, loads, speeds, mu,
                framework, total_weight, theta=None):
    """The reference's assembly-then-reduce per-turn reduction
    (``costs.cost_matrix_from_aggregate`` + ``dissatisfaction_from_cost``),
    used by ``refine_traced`` as the reference's traced scan uses it."""
    cost = costs.cost_matrix_from_aggregate(
        aggregate, assignment, node_weights, loads, speeds, mu, framework,
        total_weight=total_weight)
    return costs.dissatisfaction_from_cost(cost, assignment, theta)


def refine_simultaneous(problem, assignment,
                        framework: str = costs.C_FRAMEWORK,
                        max_sweeps: int = 256, tol: float = DEFAULT_TOL,
                        theta=None, recorder=None):
    """§4.5 mode: every machine moves its most dissatisfied node in the
    same sweep (descent not guaranteed).  The K disjoint moves apply as one
    rank-K update and both potentials come from the O(K) closed forms.

    Returns ``(RefineResult, (c0s, ct0s, active))`` with per-sweep
    potentials; ``num_moves`` counts actual transfers.
    """
    _no_recorder(recorder)
    costs.require_dense(problem)
    k = problem.num_machines
    dev = problem.device
    theta = _resolve_theta(theta, problem)
    agg = agg_mod.init_aggregate_state(problem, assignment)
    total_b = torch.sum(problem.node_weights)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    moves = _zero_i32(dev)
    kidx = torch.arange(k, device=dev)
    c0s, ct0s, actives = [], [], []
    for _ in range(max_sweeps):
        dissat, best = _assembled_dissat(agg.aggregate, agg.assignment,
                                   problem.node_weights, agg.loads,
                                   problem.speeds, problem.mu, framework,
                                   total_b, theta)
        # per machine: the most dissatisfied owned node (first maximum)
        owned = agg.assignment.long()[None, :] == kidx[:, None]   # (K, N)
        masked = torch.where(owned, dissat[None, :], -float("inf"))
        pick = torch.argmax(masked, dim=1)                        # (K,)
        gains = torch.max(masked, dim=1).values
        will_move = gains > tol
        any_move = torch.any(will_move) & ~done
        new = agg_mod.apply_sweep(problem, agg, pick,
                                  best.index_select(0, pick), will_move,
                                  total_b)
        agg = agg_mod.AggregateState(*(torch.where(any_move, n_, o)
                                       for n_, o in zip(new, agg)))
        moves = moves + torch.where(
            any_move, torch.sum(will_move.to(torch.int32)), 0).to(
                torch.int32)
        done = done | ~any_move
        c0s.append(agg.c0)
        ct0s.append(agg.ct0)
        actives.append(any_move)
    active = torch.stack(actives)
    result = RefineResult(
        assignment=agg.assignment, loads=agg.loads, num_moves=moves,
        num_turns=torch.sum(active.to(torch.int32)), converged=done,
        aggregate_drift=torch.zeros((), device=dev))
    return result, (torch.stack(c0s), torch.stack(ct0s), active)
