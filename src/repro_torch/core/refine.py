"""Iterative partition refinement (paper §4.2, Fig. 1/2), PyTorch port of
``repro.core.refine``.

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
  * ``refine_sweeps``       — multi-move probabilistic sweeps
                              (DESIGN.md §17), with the §4.5 mode as its
                              degenerate setting.

Every entry point takes a dense ``PartitionProblem`` or a
:class:`~repro_torch.core.sparse.SparseProblem`; the per-turn math is the
same (costs assemble from the carried (N, K) aggregate), only the
aggregate's build and updates walk the edge list instead.

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

import time
from typing import NamedTuple, Protocol

import numpy as np
import torch

from ..kernels import ops
from ..obs.rows import TurnRows, decode, read_back
from . import aggregate as agg_mod
from . import checkpoint as ckpt_mod
from . import costs
from .problem import PartitionState, as_assignment, make_state

# Dissatisfaction below this threshold counts as "satisfied" — guards float
# round-off from keeping the loop alive on a plateau.
DEFAULT_TOL = 1e-6

# Mover-buffer slots for the unbounded sweep apply (DESIGN.md §17): sets
# up to this size update through apply_moves' incident windows; larger
# sets fall back to the O(E) rebuild.
_UNBOUNDED_APPLY_CAP = 4096

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


def _open_run(recorder, runtime: str, problem, assignment, framework: str,
              theta, **extra):
    """Emit a ``run_start`` with the replay seed: the initial (K,) machine
    loads (a host-side scatter in f64, O(N), as the reference sums them)
    and the machine speeds, read from the device in one transfer.
    Returns ``(run id, the node weights' host copy)``."""
    b, r0, speeds = read_back(problem.node_weights,
                              as_assignment(assignment, problem.device),
                              problem.speeds)
    k = problem.num_machines
    loads0 = np.zeros(k)
    np.add.at(loads0, r0, b)
    run = recorder.new_run(
        runtime, framework=framework, n=problem.num_nodes, k=k,
        theta=theta is not None, loads=loads0, speeds=speeds, **extra)
    return run, b


def _raw_best_gain(dissat, assignment, machine: int, theta):
    """Telemetry side quantity: the machine's best gain BEFORE the θ
    hysteresis netting (DESIGN.md §14.1).  ``dissat`` is net of theta, so
    the raw value is recovered as ``net + theta`` over the owned nodes.
    Lets the recorder label a rejected turn "hysteresis" (the raw gain
    cleared tol, the net one did not) or "satisfied".  Only evaluated on
    telemetry paths."""
    raw = dissat if theta is None else dissat + theta
    return torch.max(torch.where(assignment == machine, raw, -float("inf")))


def _host_result(result: RefineResult, *more: torch.Tensor):
    """``result`` as host numpy arrays, and ``more``'s, in one transfer."""
    vals = read_back(*result, *more)
    return RefineResult(*vals[:len(result)]), vals[len(result):]


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
    whether it moves.  ``node`` keeps the reduced axis, (1,) — or (B, 1)
    for a fleet's (B, N) ``dissat``, one pick per element."""
    owned = assignment == machine
    masked = torch.where(owned, dissat, -float("inf"))
    node = torch.argmax(masked, dim=-1, keepdim=True)
    gain = masked.gather(-1, node)[..., 0]
    do_move = (gain > tol) & active
    return node, gain, do_move


def _result(do_move, node, machine: int, dest, gain, c0, ct0) -> TurnResult:
    node32 = node[..., 0].to(torch.int32)
    return TurnResult(
        moved=do_move,
        node=torch.where(do_move, node32, -1),
        source=torch.where(do_move, node32.new_full((), machine), -1),
        dest=torch.where(do_move, dest[..., 0].to(torch.int32), -1),
        gain=torch.where(do_move, gain, 0.0),
        c0=c0, ct0=ct0)


def _turn(problem, state: PartitionState, machine: int, framework: str,
          tol: float, cost_matrix_fn=None, theta=None, active=True):
    """One machine turn, recompute path: rebuild costs from scratch.
    Returns the new state, the turn's result and the turn's (N,)
    dissatisfaction (for telemetry)."""
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
    return PartitionState(new_assignment, new_loads), res, dissat


def _turn_incremental(problem, agg: agg_mod.AggregateState, machine: int,
                      framework: str, tol: float, total_b, dissat_fn,
                      theta=None, active=True):
    """One machine turn, incremental path: O(NK) costs from the carried
    aggregate, O(N) rank-1 move (DESIGN.md §10).  A fleet's carry (a
    (B, N, K) aggregate, every field with a leading B axis, see
    :mod:`repro_torch.core.batch`) takes the same turn in every element
    at once.  Returns the new carry, the turn's result and the turn's
    dissatisfaction (for telemetry)."""
    dissat, best = dissat_fn(agg.aggregate, agg.assignment,
                             problem.node_weights, agg.loads, problem.speeds,
                             problem.mu, framework, total_b, theta)
    node, gain, do_move = _pick(dissat, agg.assignment, machine, tol, active)
    dest = best.gather(-1, node)
    new_agg = agg_mod.apply_move(problem, agg, node, machine, dest, do_move,
                                 total_b)
    res = _result(do_move, node, machine, dest, gain, new_agg.c0,
                  new_agg.ct0)
    return new_agg, res, dissat


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

    ``recorder`` (a :class:`repro_torch.obs.Recorder`, DESIGN.md §14) opts
    into telemetry: each turn appends its row to a buffer on the device
    (no host read), the rows are read back once after the run — the
    masked turns past convergence dropped — and emitted as ``turn``
    events, and the run closes with drift + ``run_end`` events.  The
    recorder adds two host reads a run (the replay seed before the loop,
    the rows and the result after it), none a turn.  ``recorder=None``
    (default) runs exactly the recorder-free loop.
    """
    kwargs = dict(max_turns=max_turns, tol=tol,
                  cost_matrix_fn=cost_matrix_fn, incremental=incremental,
                  verify_every=verify_every, repair_every=repair_every,
                  dissat_fn=dissat_fn, theta=theta)
    if recorder is None:
        return _refine(problem, assignment, framework, **kwargs)
    carried = incremental and cost_matrix_fn is None
    run, b = _open_run(recorder, "refine", problem, assignment, framework,
                       theta, incremental=carried)
    rows = TurnRows()
    recorder.begin_rows()
    t0 = time.perf_counter()
    with recorder.phase("core.refine", run):
        result = _refine(problem, assignment, framework, rows=rows,
                         **kwargs)
        host, (raw,) = _host_result(
            result, rows.tensor(len(_TURN_ROW), problem.device))
    wall = time.perf_counter() - t0
    k = problem.num_machines
    cols = decode(raw, _TURN_ROW)
    for t, (active, *row) in enumerate(zip(*cols)):
        if active:
            recorder._on_turn_row(t, t % k, *row)
    turn_rows = recorder.take_rows()
    recorder.record_turn_rows(run, turn_rows, b, carried=carried)
    last = turn_rows[-1] if turn_rows else None
    recorder.record_result(
        run, host, wall=wall,
        c0=float(last[7]) if carried and last is not None else None,
        ct0=float(last[8]) if carried and last is not None else None)
    return result


# A telemetry turn row: active, moved, node, source, dest, gain, c0, ct0,
# raw gain (the recorder's row is the turn index and the machine, then
# the rest).
_TURN_ROW = "bbiiiffff"


def _refine(problem, assignment, framework: str, max_turns: int, tol: float,
            cost_matrix_fn, incremental: bool, verify_every: int,
            repair_every: int, dissat_fn, theta,
            rows: TurnRows | None = None) -> RefineResult:
    """The loop of :func:`refine`; ``rows`` (telemetry) takes each turn's
    row on the device."""
    costs.is_sparse(problem)        # TypeError for anything else
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
        before = carry.assignment
        if incremental:
            carry, res, dissat = _turn_incremental(
                problem, carry, t % k, framework, tol, total_b, dissat_fn,
                theta, active)
        else:
            carry, res, dissat = _turn(problem, carry, t % k, framework,
                                       tol, cost_matrix_fn, theta, active)
        if rows is not None:
            rows.append(active, *res,
                        _raw_best_gain(dissat, before, t % k, theta))
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

    ``recorder`` opts into telemetry (DESIGN.md §14): after the run the
    trace — with a θ-free raw gain per turn, for hysteresis-vs-satisfied
    rejection labels — is read back once and ingested into per-turn
    events, and the run closes with drift + ``run_end`` events.
    ``recorder=None`` (default) runs exactly the recorder-free loop.
    """
    if recorder is None:
        return _refine_traced(problem, assignment, framework, max_turns,
                              tol, incremental, verify_every, theta)
    run, b = _open_run(recorder, "refine_traced", problem, assignment,
                       framework, theta, incremental=incremental)
    raws: list = []
    t0 = time.perf_counter()
    with recorder.phase("core.refine_traced", run):
        result, trace = _refine_traced(problem, assignment, framework,
                                       max_turns, tol, incremental,
                                       verify_every, theta, raws)
        host, more = _host_result(result, *trace, *raws)
    wall = time.perf_counter() - t0
    tr = Trace(*more[:len(trace)])
    recorder.record_trace(run, tr, b, problem.num_machines,
                          raw_gain=np.asarray(more[len(trace):]))
    last = max(int(host.num_turns) - 1, 0)
    recorder.record_result(run, host, wall=wall, c0=float(tr.c0[last]),
                           ct0=float(tr.ct0[last]))
    return result, trace


def _refine_traced(problem, assignment, framework: str, max_turns: int,
                   tol: float, incremental: bool, verify_every: int, theta,
                   raws: list | None = None):
    """The loop of :func:`refine_traced`; ``raws`` (telemetry) takes each
    turn's θ-free best gain."""
    costs.is_sparse(problem)        # TypeError for anything else
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
        before = carry.assignment
        if incremental:
            carry, res, dissat = _turn_incremental(
                problem, carry, t % k, framework, tol, total_b,
                _assembled_dissat, theta, active)
            c0, ct0 = carry.c0, carry.ct0
        else:
            carry, res, dissat = _turn(problem, carry, t % k, framework, tol,
                                       theta=theta, active=active)
            c0 = costs.global_cost_c0(problem, carry.assignment)
            ct0 = costs.global_cost_ct0(problem, carry.assignment)
        if raws is not None:
            raws.append(_raw_best_gain(dissat, before, t % k, theta))
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
    potentials; ``num_moves`` counts actual transfers.  This is
    :func:`refine_sweeps`' degenerate setting (``moves_per_machine=1``,
    ``move_prob=1``, ``epsilon=0``), run by the same sweep body, so the
    two agree bitwise by construction (DESIGN.md §17).  ``recorder`` as
    in :func:`refine_sweeps`; its run is labelled ``refine_simultaneous``.
    """
    kwargs = dict(max_sweeps=max_sweeps, tol=tol, theta=theta)
    if recorder is None:
        return _refine_sweeps(problem, assignment, framework, **kwargs)
    return _recorded_sweeps(recorder, "refine_simultaneous", {}, problem,
                            assignment, framework, theta, kwargs)


class SweepCandidateFn(Protocol):
    """Fused sweep-election convention (DESIGN.md §17.4): the same 9
    positional arguments as :class:`DissatFn`, returning the per-MACHINE
    election ``(gains (K,), picks (K,), dests (K,))``: machine m's best
    net dissatisfaction among its owned nodes, that node (lowest index on
    ties) and its lowest-index arg-best machine.  Factory:
    :func:`repro_torch.kernels.ops.make_edge_sweep_fn`.  Consumed by
    :func:`refine_sweeps` with ``moves_per_machine=1``.
    """

    def __call__(self, aggregate, assignment, node_weights, loads, speeds,
                 mu, framework: str, total_weight,
                 theta=None) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """Returns ``(gains (K,), picks (K,), dests (K,))``."""
        ...


def _top_m(masked: torch.Tensor, m: int):
    """Each row's M largest entries, lowest index first among equals (the
    order of ``jax.lax.top_k``; ``torch.topk`` does not promise it)."""
    values, index = torch.sort(masked, dim=1, descending=True, stable=True)
    return values[:, :m], index[:, :m]


def _adaptive_coin(agg, problem, best, cand, move_prob: float, generator):
    """The unbounded mode's per-candidate coin (arXiv:cs/0506098): rate
    ``move_prob · min(1, gap_i / W_dest)``, ``gap_i`` being half the
    source→destination normalized-load imbalance and ``W_dest`` the total
    candidate weight aimed at the destination, so each destination's
    expected inflow stays below its deficit.  Returns ``(coin, cand)``
    with candidates of non-positive gap dropped: their rate is 0 on this
    and every later sweep, so they must not keep the run alive."""
    k = problem.num_machines
    dt = problem.node_weights.dtype
    best = best.long()
    norm = agg.loads / problem.speeds                            # (K,)
    gap = 0.5 * (norm.index_select(0, agg.assignment.long())
                 - norm.index_select(0, best)) \
        * problem.speeds.index_select(0, best)                   # (N,)
    # per-destination candidate weight as a one-hot product: a fixed
    # summation order, where index_add_ would sum with atomics
    onehot = (best[:, None] == torch.arange(k, device=best.device)).to(dt)
    w_dest = torch.where(cand, problem.node_weights, 0.0) @ onehot  # (K,)
    frac = gap / torch.clamp(w_dest.index_select(0, best), min=1e-30)
    rate = move_prob * torch.clamp(frac, 0.0, 1.0)
    coin = torch.rand(rate.shape, generator=generator, device=rate.device,
                      dtype=rate.dtype) < rate
    return coin, cand & (frac > 0)


def refine_sweeps(problem, assignment, framework: str = costs.C_FRAMEWORK,
                  max_sweeps: int = 256, tol: float = DEFAULT_TOL,
                  theta=None, moves_per_machine: int | None = 1,
                  move_prob: float = 1.0, epsilon: float = 0.0,
                  generator: torch.Generator | None = None,
                  dissat_fn: DissatFn | None = None,
                  sweep_fn: SweepCandidateFn | None = None, recorder=None):
    """Multi-move probabilistic sweeps (DESIGN.md §17): the §4.5
    simultaneous mode generalized so convergence is O(sweeps), not
    O(moves).

    Per sweep, candidates are elected by ``moves_per_machine``:

      * ``1`` (default) — each machine's most dissatisfied node, exactly
        :func:`refine_simultaneous`'s election;
      * ``M > 1`` — each machine's top-M owned nodes, applied as one
        rank-K·M update (:func:`~repro_torch.core.aggregate.apply_moves`);
      * ``None`` — unbounded: every node whose net dissatisfaction clears
        the threshold.  Up to 4096 accepted movers (lowest indices
        first) go through ``apply_moves``' incident windows; a larger
        set falls back to the O(E·K) rebuild
        (:func:`~repro_torch.core.aggregate.rebuild_state`).

    ``move_prob < 1`` thins the candidates with independent coins drawn
    from ``generator`` (a ``torch.Generator`` on the problem's device,
    required then): a flat ``move_prob`` rate in the elected modes, and
    in the unbounded mode per-candidate rates from the cs/0506098
    expected-drop bound (:func:`_adaptive_coin`).  ``move_prob >= 1``
    draws nothing: ``accept`` is ``cand``.  ``epsilon`` raises the
    acceptance floor to ``tol + ε·|Φ|/N`` on the carried potential — the
    ε-equilibrium threshold of arXiv:1305.3354.  The run has converged
    when no candidate clears the threshold; the loop then stops, and the
    per-sweep outputs are padded as the reference's masked sweeps leave
    them (the last potentials, ``active`` False).

    ``dissat_fn`` is the 9-argument seam (default: the reference's
    assembled cost matrix and reduction, as ``refine_simultaneous`` uses
    it); ``sweep_fn`` (:class:`SweepCandidateFn`) fuses the election
    into a kernel (``moves_per_machine=1`` only).

    Host syncs: each sweep reads one flag (with the accepted count in the
    unbounded mode, which chooses the mover buffer or the rebuild), and
    each multi-window update reads its deepest row group
    (:func:`~repro_torch.core.aggregate.add_windows`).

    ``recorder`` (a :class:`repro_torch.obs.Recorder`) opts into
    telemetry: per-sweep events (potentials and movers, read back once
    after the run) plus drift + ``run_end``; ``recorder=None`` (default)
    runs exactly the recorder-free loop.

    Returns ``(RefineResult, (c0s, ct0s, active))`` like
    :func:`refine_simultaneous`.
    """
    if move_prob < 1.0 and generator is None:
        raise ValueError("refine_sweeps(move_prob < 1) needs a "
                         "torch.Generator `generator` for the per-sweep "
                         "acceptance coins")
    if sweep_fn is not None and moves_per_machine != 1:
        raise ValueError("sweep_fn fuses the one-move-per-machine election "
                         "(moves_per_machine=1); use dissat_fn for the "
                         "other modes")
    if sweep_fn is not None and dissat_fn is not None:
        raise ValueError("pass sweep_fn or dissat_fn, not both (sweep_fn "
                         "subsumes the per-node reduction)")
    kwargs = dict(max_sweeps=max_sweeps, tol=tol, theta=theta,
                  moves_per_machine=moves_per_machine, move_prob=move_prob,
                  epsilon=epsilon, generator=generator, dissat_fn=dissat_fn,
                  sweep_fn=sweep_fn)
    if recorder is None:
        return _refine_sweeps(problem, assignment, framework, **kwargs)
    meta = dict(moves_per_machine=(-1 if moves_per_machine is None
                                   else moves_per_machine),
                move_prob=move_prob, epsilon=epsilon)
    return _recorded_sweeps(recorder, "refine_sweeps", meta, problem,
                            assignment, framework, theta, kwargs)


def _recorded_sweeps(recorder, runtime: str, meta: dict, problem,
                     assignment, framework: str, theta, kwargs: dict):
    """A sweep run under ``recorder``: ``run_start``, the timed run, one
    read-back of its per-sweep outputs and movers, ``sweep`` events and
    the closing drift + ``run_end``."""
    run, _ = _open_run(recorder, runtime, problem, assignment, framework,
                       theta, **meta)
    movers: list = []
    t0 = time.perf_counter()
    with recorder.phase(f"core.{runtime}", run):
        result, outs = _refine_sweeps(problem, assignment, framework,
                                      movers=movers, **kwargs)
        host, (c0s, ct0s, active, *mv) = _host_result(result, *outs,
                                                      *movers)
    wall = time.perf_counter() - t0
    mv = np.asarray(mv + [0] * (len(active) - len(mv)), np.int32)
    recorder.record_sweeps(run, c0s, ct0s, active, movers=mv)
    last = max(int(host.num_turns) - 1, 0)
    recorder.record_result(run, host, wall=wall, c0=float(c0s[last]),
                           ct0=float(ct0s[last]))
    return result, outs


def _refine_sweeps(problem, assignment, framework: str, max_sweeps: int,
                   tol: float, theta, moves_per_machine: int | None = 1,
                   move_prob: float = 1.0, epsilon: float = 0.0,
                   generator=None, dissat_fn=None, sweep_fn=None,
                   movers: list | None = None):
    """The loop of :func:`refine_sweeps`; ``movers`` (telemetry) takes
    each executed sweep's accepted count."""
    costs.is_sparse(problem)        # TypeError for anything else
    k = problem.num_machines
    n = problem.num_nodes
    dev = problem.device
    theta = _resolve_theta(theta, problem)
    if dissat_fn is None:
        dissat_fn = _assembled_dissat
    elected = sweep_fn is not None or moves_per_machine == 1
    unbounded = sweep_fn is None and moves_per_machine is None
    agg = agg_mod.init_aggregate_state(problem, assignment)
    total_b = torch.sum(problem.node_weights)
    moves = _zero_i32(dev)
    kidx = torch.arange(k, device=dev)
    c0s, ct0s, actives = [], [], []
    converged = False
    for _ in range(max_sweeps):
        if epsilon:
            pot = agg.c0 if framework == costs.C_FRAMEWORK else agg.ct0
            thresh = tol + epsilon * torch.abs(pot) / n
        else:
            thresh = tol
        args = (agg.aggregate, agg.assignment, problem.node_weights,
                agg.loads, problem.speeds, problem.mu, framework, total_b,
                theta)
        if sweep_fn is not None:
            gains, pick, dest = sweep_fn(*args)
        else:
            dissat, best = dissat_fn(*args)
            if not unbounded:
                owned = agg.assignment.long()[None, :] == kidx[:, None]
                masked = torch.where(owned, dissat[None, :],
                                     -float("inf"))            # (K, N)
                if elected:
                    # the most dissatisfied owned node (first maximum)
                    pick = torch.argmax(masked, dim=1)
                    gains = torch.max(masked, dim=1).values
                else:
                    gains, pick = _top_m(masked, moves_per_machine)
                    gains, pick = gains.reshape(-1), pick.reshape(-1)
                dest = best.index_select(0, pick.long())
        cand = (dissat if unbounded else gains) > thresh
        if move_prob < 1.0:
            if unbounded:
                coin, cand = _adaptive_coin(agg, problem, best, cand,
                                            move_prob, generator)
            else:
                coin = torch.rand(cand.shape, generator=generator,
                                  device=dev) < move_prob
            accept = cand & coin
        else:
            accept = cand
        any_cand = torch.any(cand)
        n_acc = torch.sum(accept.to(torch.int32))
        if unbounded:
            # host sync: the flag and the accepted count in one read
            flag, count = torch.stack([any_cand.to(torch.int32),
                                       n_acc]).tolist()
        else:
            flag = bool(any_cand)                   # host sync
        if not flag:
            converged = True
            break
        if elected:
            agg = agg_mod.apply_sweep(problem, agg, pick, dest, accept,
                                      total_b)
        elif not unbounded:
            agg = agg_mod.apply_moves(problem, agg, pick, dest, accept,
                                      total_b)
        elif count <= min(_UNBOUNDED_APPLY_CAP, n):
            # the buffer's first `count` slots hold every mover; the rest
            # would be masked fill adding exact zeros, so they are left out
            idx = _mover_buffer(accept, count)
            agg = agg_mod.apply_moves(problem, agg, idx,
                                      best.index_select(0, idx),
                                      torch.ones_like(idx, dtype=torch.bool),
                                      total_b)
        else:
            agg = agg_mod.rebuild_state(
                problem, torch.where(accept, best, agg.assignment), total_b)
        moves = moves + n_acc
        if movers is not None:
            movers.append(n_acc)
        c0s.append(agg.c0)
        ct0s.append(agg.ct0)
        actives.append(True)
    pad = max_sweeps - len(actives)
    c0s += [agg.c0] * pad
    ct0s += [agg.ct0] * pad
    active = torch.tensor(actives + [False] * pad, dtype=torch.bool,
                          device=dev)
    result = RefineResult(
        assignment=agg.assignment, loads=agg.loads, num_moves=moves,
        num_turns=torch.sum(active.to(torch.int32)),
        converged=torch.tensor(converged, device=dev),
        aggregate_drift=torch.zeros((), device=dev))
    return result, (torch.stack(c0s), torch.stack(ct0s), active)


def _mover_buffer(accept: torch.Tensor, size: int) -> torch.Tensor:
    """The first ``size`` accepted node ids, lowest first, compacted by a
    cumulative sum (no ``nonzero``, which syncs)."""
    slot = torch.cumsum(accept.to(torch.int64), 0) - 1
    slot = torch.where(accept & (slot < size), slot, size)
    buf = torch.zeros(size + 1, dtype=torch.int64, device=accept.device)
    buf[slot] = torch.arange(accept.shape[0], device=accept.device)
    return buf[:size]


def count_discrepancies(trace: Trace, framework: str, initial_other,
                        rel_tol: float = 1e-4) -> torch.Tensor:
    """§5.1: a C_0-discrepancy is a move that *increases* C_0 while using
    Ct_i as the local criterion (and vice versa).  ``framework`` names the
    criterion that *was* used; we count ascents of the OTHER potential.
    ``initial_other`` is that potential's value before the first turn.

    ``rel_tol`` sets what counts as an ascent: the potentials are O(1e6)
    f32 sums over N^2 terms, so sub-1e-5-relative deltas are accumulation
    noise; 1e-4 keeps every O(0.01%)-or-larger true ascent while rejecting
    noise.  The paper does not publish its counting rule; the claim
    reproduced is the ORDERING: Ct_0-discrepancies >> C_0-ones.
    """
    other = trace.c0 if framework == costs.CT_FRAMEWORK else trace.ct0
    first = torch.as_tensor(initial_other, dtype=other.dtype,
                            device=other.device).reshape(1)
    prev = torch.cat([first, other[:-1]])
    ascent = (other - prev > rel_tol * torch.abs(prev)) & trace.moved
    return torch.sum(ascent.to(torch.int32))
