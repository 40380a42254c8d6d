"""Sharded refinement drivers (DESIGN.md §9), PyTorch port of
``repro.distributed.runtime``.

Three execution modes over the same shard-local reduction + O(K) protocol:

  * :func:`refine_distributed`          — sequential round-robin turns to
    convergence (the production entry point; what ``repro_torch.des``
    calls when ``refine_backend="distributed"``);
  * :func:`refine_distributed_traced`   — a fixed number of turns,
    recording the per-turn move sequence and both global potentials;
  * :func:`refine_distributed_simultaneous` — the §4.5 sweep mode: every
    machine moves its most dissatisfied node in the same round.

Shard-local compute is **incremental by default** (DESIGN.md §10): the S
shards' (Ns, K) row-block aggregates are carried as one (S, Ns, K) stack
(built once from the controller's own aggregate product), each turn
reduces the whole stack in one call, and the elected move is applied as
the controller's rank-1 column update, each shard using only its own rows.
``incremental=False`` restores the recompute path: every turn rebuilds the
shards' cost rows from their (S*Ns, N) row blocks.

What ``cost_fn`` means in the port.  Each driver's default reduction is
the one its single-controller counterpart uses, so that the distributed
run is bitwise the controller's:

  * ``refine_distributed``, incremental: ``"jnp"`` and ``"pallas"`` both
    reduce with kernel 3 (kernel 1's body over the (S, Ns, K) stack,
    ``ops.dissatisfaction_from_aggregate_batched``) on the card and its
    plain twin on the CPU — per row bitwise kernel 1, which ``refine``
    reduces with;
  * ``refine_distributed_traced`` and ``refine_distributed_simultaneous``,
    incremental: ``"jnp"`` is the assembled cost matrix and separate
    reduction ``refine_traced`` and ``refine_simultaneous`` use
    (``refine._assembled_dissat``); ``"pallas"`` is kernel 3;
  * recompute (``incremental=False``): ``"jnp"`` assembles the cost rows
    from the rows of the controller's aggregate product; ``"pallas"``
    runs kernel 2 (``ops.cost_matrix``) on the flattened (S*Ns, N) row
    blocks, one launch a turn.

Any other ``cost_fn`` raises ``ValueError``.

The loops are Python loops on the host.  The sequential drivers never wait
on the card inside a turn: the move gate and the counters stay device
tensors, turns after convergence are masked inactive, and the host reads
the convergence flag once every ``_SYNC_EVERY`` turns, as
:func:`repro_torch.core.refine.refine` does.  The sweep drivers read one
flag a sweep, as ``refine_simultaneous`` does.

Two drivers realize the SPMD program:

  * the **emulated** drivers hold every shard on one device and perform
    the exchange as a stack of the S candidates;
  * :func:`refine_distributed_shard_map` runs one shard per rank of a
    ``torch.distributed`` process group (NCCL on the card, gloo on the
    CPU), each rank reducing its own block with kernel 1 and exchanging
    the 16-byte candidate with ``all_gather``.

Within the port the sequential drivers are bitwise the controller (move
sequence, assignment, loads, turns).  Quantities reduced from per-shard
partials — the traced drivers' initial potentials, the sweep drivers'
loads, squared loads and cut each sweep, the recompute traced path's
potentials — are f32 sums of S partial sums: bitwise the controller's
with one shard, and equal to f32 reassociation with more.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import NamedTuple

import torch

from ..core import aggregate as agg_mod
from ..core import costs
from ..core.problem import PartitionProblem, make_state
from ..core.refine import (_SYNC_EVERY, DEFAULT_TOL, RefineResult, Trace,
                           _assembled_dissat, _open_run, _resolve_theta)
from ..kernels import ops
from . import accounting, faults, protocol
from .views import ShardViews, boundary_stats, build_views, shard_node_values


# Declared asymptotic budgets for the distributed drivers, consumed by
# the complexity analyzers (``repro_torch.analysis``, DESIGN.md §18).
# The drivers shard the dense representation, so per-driver memory/work
# carry the dense budget; the paper's feasibility claim (§5 of arXiv
# 1111.0875) lives in the collective schedule instead — see
# DISTRIBUTED_COLLECTIVES below.
DISTRIBUTED_COMPLEXITY = {
    "mem": {"n": 2.0, "k": 1.0},
    "ops": {"n": 2.0, "k": 1.0},
}

# Per-driver collective budget: total per-shard operand bytes of the
# collectives a run issues, split into the per-round ("recurring": what a
# second turn adds) and one-off ("setup") phases.  The emulated drivers
# exchange through stacked buffers audited by the wire rules (§9.2), so
# they must issue ZERO collectives; the collective driver gathers exactly
# one candidate per round — one all_gather of a (4,) int32 message whose
# per-shard operand is protocol.CANDIDATE_BYTES (``_gather_candidates``,
# §14.5), independent of N — and issues no setup collective (only its
# fault-injected runs all-reduce, ``_all_reduce``).
DISTRIBUTED_COLLECTIVES = {
    "distributed.refine": {"recurring_bytes": 0, "setup_bytes": 0},
    "distributed.refine_traced": {"recurring_bytes": 0, "setup_bytes": 0},
    "distributed.refine_simultaneous": {"recurring_bytes": 0,
                                        "setup_bytes": 0},
    "distributed.shard_map": {"recurring_bytes": protocol.CANDIDATE_BYTES,
                              "setup_bytes": 0},
}


class WireMeasurement(NamedTuple):
    """Measured exchange bytes of one distributed run (DESIGN.md §14.5).

    Produced by the drivers under ``measure_wire=True``: ``payload_bytes``
    is the byte size of the tensors that actually crossed the emulated
    (or real) exchange each round — ``numel * element_size`` of the
    stacked candidates and partials, not the analytic formulas — times
    the rounds the run executed, plus a fault plan's retry and repair
    bytes; ``setup_bytes`` covers the one-time replicated state (O(K)
    loads + total-B scalar, plus the initial-potential partials on the
    incremental traced path).  ``rounds`` counts active turns/sweeps,
    like ``RefineResult.num_turns`` and
    :func:`repro_torch.distributed.accounting.ledger_for_run`.
    """
    rounds: int
    payload_bytes: int
    setup_bytes: int


class FaultTrace(NamedTuple):
    """Per-round repair side channel of the faulty traced/sweep drivers."""
    repaired: torch.Tensor       # (T,) bool — in-loop repair fired
    repair_drift: torch.Tensor   # (T,) f32  — worst pre-repair deviation
    repaired_cols: torch.Tensor  # (T,) i32  — aggregate columns replaced


def _nbytes(tensors) -> int:
    """Total byte size of the tensors (a tensor, or nested tuples)."""
    if isinstance(tensors, torch.Tensor):
        return tensors.numel() * tensors.element_size()
    return sum(_nbytes(t) for t in tensors)


def _resolve_shards(problem: PartitionProblem, num_shards: int | None) -> int:
    if num_shards is None:
        num_shards = problem.num_machines
    return max(1, min(num_shards, problem.num_nodes))


def shard_problem(problem: PartitionProblem, num_shards: int) -> ShardViews:
    """Build the static per-shard views for ``problem`` (see views.py)."""
    return build_views(problem, num_shards)


def _fused(cost_fn: str, default: bool) -> bool:
    """Whether the incremental reduction is kernel 3 (see the module
    docstring for what each ``cost_fn`` means)."""
    if cost_fn not in ("jnp", "pallas"):
        raise ValueError(f"unknown cost_fn {cost_fn!r}")
    return default or cost_fn == "pallas"


def _zero(device, dtype=torch.int32) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


class _Shards:
    """The per-run constants of an emulated run: the views, the initial
    replicated state, the global weight total and the stacked operands
    kernel 3 takes (every replicated one with a leading S axis)."""

    def __init__(self, problem: PartitionProblem, assignment, num_shards,
                 theta):
        self.problem = problem
        self.k = k = problem.num_machines
        self.s = s = _resolve_shards(problem, num_shards)
        self.views = views = build_views(problem, s)
        self.ns = views.shard_size
        self.rows = views.flat_rows()                       # (S*Ns, N)
        state0 = make_state(problem, assignment)
        self.r0, self.loads0 = state0.assignment, state0.loads
        self.total_b = torch.sum(problem.node_weights)
        theta = _resolve_theta(theta, problem)
        self.theta = (None if theta is None
                      else shard_node_values(theta, s))     # (S, Ns)
        self.ids_flat = views.ids.reshape(-1).long()
        self.speeds_s = problem.speeds.expand(s, k).contiguous()
        self.mu_s = problem.mu.reshape(1).expand(s).contiguous()
        self.total_s = self.total_b.reshape(1).expand(s).contiguous()
        self.sq_weights = views.weights * views.weights
        self.device = problem.device

    def r_local(self, assignment: torch.Tensor) -> torch.Tensor:
        """(S, Ns) the shards' rows' own machines, from the mirror."""
        return assignment.index_select(0, self.ids_flat).view(self.s,
                                                              self.ns)

    def loads_s(self, loads: torch.Tensor) -> torch.Tensor:
        return loads.expand(self.s, self.k).contiguous()

    def aggregates(self, assignment) -> torch.Tensor:
        return protocol.block_aggregates(self.problem, assignment, self.s)

    def reduce(self, aggs, r_local, loads, framework: str, fused: bool):
        """(S, Ns) dissatisfaction and best machine of every shard's rows
        from the (S, Ns, K) stack: kernel 3 (one launch for all shards) or
        the controller's assembled reduction."""
        p = self.problem
        if fused:
            return ops.dissatisfaction_from_aggregate_batched(
                aggs, r_local, self.views.weights, self.loads_s(loads),
                self.speeds_s, self.mu_s, self.total_s, framework,
                theta=self.theta)
        dissat, best = _assembled_dissat(
            aggs.reshape(-1, self.k), r_local.reshape(-1),
            self.views.weights.reshape(-1), loads, p.speeds, p.mu,
            framework, self.total_b,
            None if self.theta is None else self.theta.reshape(-1))
        return dissat.view(self.s, self.ns), best.view(self.s, self.ns)

    def recompute(self, assignment, r_local, loads, framework: str,
                  cost_fn: str):
        """(S, Ns) dissatisfaction and best machine rebuilt from scratch:
        kernel 2 on the (S*Ns, N) row blocks, or the assembled rows of
        the controller's aggregate product."""
        p = self.problem
        rl = r_local.reshape(-1)
        weights = self.views.weights.reshape(-1)
        if cost_fn == "pallas":
            cost = ops.cost_matrix(self.rows, assignment, weights, loads,
                                   p.speeds, p.mu, framework,
                                   row_assignment=rl,
                                   total_weight=self.total_b)
        elif cost_fn == "jnp":
            cost = protocol.shard_cost_from_aggregate(
                self.aggregates(assignment).view(-1, self.k), rl, weights,
                loads, p.speeds, p.mu, self.total_b, framework)
        else:
            raise ValueError(f"unknown cost_fn {cost_fn!r}")
        dissat, best = costs.dissatisfaction_from_cost(
            cost, rl, None if self.theta is None else self.theta.reshape(-1))
        return dissat.view(self.s, self.ns), best.view(self.s, self.ns)

    def candidates(self, dissat, best, r_local, machine: int):
        v = self.views
        return protocol.local_candidates(dissat, best, r_local, v.weights,
                                         v.ids, v.valid, machine)

    def update(self, aggs, node, col_delta) -> torch.Tensor:
        return protocol.update_block_aggregate(
            aggs.view(-1, self.k), self.rows, node,
            col_delta).view(self.s, self.ns, self.k)

    def load_partials(self, r_local, squared: bool = False):
        w = self.sq_weights if squared else self.views.weights
        return protocol.shard_load_partials(w, self.views.valid, r_local,
                                            self.k)

    def potentials(self, aggs, assignment, fresh_loads):
        """(C_0, Ct_0) reduced from per-shard C_0 and cut partials, and
        the partials' byte size."""
        p, v = self.problem, self.views
        r_local = self.r_local(assignment)
        c0p = protocol.shard_c0_partials(aggs, v.weights, v.valid, r_local,
                                         fresh_loads, p.speeds, p.mu,
                                         self.total_b)
        cutp = protocol.shard_cut_partials(v.row_block, v.valid, r_local,
                                           assignment)
        c0, ct0 = protocol.global_potentials(c0p, cutp, fresh_loads,
                                             p.speeds, p.mu, self.total_b)
        return c0, ct0, _nbytes((c0p, cutp))

    def closed_potentials(self, aggs, r_local):
        """Fresh loads, squared loads and cut from per-shard partials, and
        both potentials by the O(K) closed forms; returns ``(loads, c0,
        ct0, partials)``."""
        p = self.problem
        load_p = self.load_partials(r_local)
        sq_p = self.load_partials(r_local, squared=True)
        cut_p = protocol.shard_cut_partials_from_aggregate(
            aggs, self.views.valid, r_local)
        loads = torch.sum(load_p, dim=0)
        cut = 0.5 * torch.sum(cut_p)
        c0, ct0 = costs.potentials_closed_form(
            loads, torch.sum(sq_p, dim=0), cut, p.speeds, p.mu,
            self.total_b)
        return loads, c0, ct0, (load_p, sq_p, cut_p)

    def setup_bytes(self) -> int:
        return _nbytes((self.loads0, self.total_b))


def _trace_row(moved, winner: protocol.Winner, machine: int, c0, ct0,
               active):
    """One turn of a :class:`Trace`, in the controller's gating
    (``refine._result``)."""
    node = winner.node.to(torch.int32)
    return (moved, torch.where(moved, node, -1),
            torch.where(moved, node.new_full((), machine), -1),
            torch.where(moved, winner.dest.to(torch.int32), -1),
            torch.where(moved, winner.gain, 0.0), c0, ct0, active)


def _sequential_turn(sh: _Shards, r, loads, winner, machine: int, active):
    """Gate the elected move by ``active`` and apply it to the replicated
    mirror and loads; returns ``(moved, col_delta, r, loads)``."""
    moved = winner.moved & active
    delta = protocol.move_delta(sh.k, machine, winner.dest, moved,
                                loads.dtype, sh.device)
    r, loads = protocol.apply_move(r, loads, winner, delta, moved)
    return moved, delta, r, loads


# ---------------------------------------------------------------------------
# Sequential round-robin turns (paper §4.2 protocol, distributed)
# ---------------------------------------------------------------------------

def _refine_distributed(problem, assignment, framework=costs.C_FRAMEWORK,
                        num_shards=None, max_turns=10_000, tol=DEFAULT_TOL,
                        cost_fn="jnp", incremental=True, theta=None,
                        measure_wire=False):
    """Distributed round-robin refinement to convergence (K idle turns).

    Protocol per turn: each shard computes one Candidate from local state
    (16 bytes on the wire), the candidates are gathered, every machine
    elects the same winner and applies the same O(1) delta to its
    replicated assignment mirror + O(K) load vector — and, on the default
    incremental path, the same rank-1 update to its carried block
    aggregate.  ``theta`` (scalar or (N,)) is the migration-price
    hysteresis threshold (DESIGN.md §11), evaluated shard-locally.
    """
    sh = _Shards(problem, assignment, num_shards, theta)
    k, dev = sh.k, sh.device
    fused = _fused(cost_fn, True)
    aggs = sh.aggregates(sh.r0) if incremental else None
    r, loads = sh.r0, sh.loads0
    idle, turns, moves = _zero(dev), _zero(dev), _zero(dev)
    per_turn = 0
    for t in range(max_turns):
        if t and t % _SYNC_EVERY == 0 and not bool(idle < k):
            break
        active = idle < k
        machine = t % k
        r_local = sh.r_local(r)
        if incremental:
            dissat, best = sh.reduce(aggs, r_local, loads, framework, fused)
        else:
            dissat, best = sh.recompute(r, r_local, loads, framework,
                                        cost_fn)
        cands, _ = sh.candidates(dissat, best, r_local, machine)
        per_turn = _nbytes(cands)
        winner = protocol.elect(cands, tol)
        moved, delta, r, loads = _sequential_turn(sh, r, loads, winner,
                                                  machine, active)
        if incremental:
            aggs = sh.update(aggs, winner.node, delta)
        idle = torch.where(moved, 0, idle + 1)
        turns = turns + active.to(torch.int32)
        moves = moves + moved.to(torch.int32)
    result = RefineResult(assignment=r, loads=loads, num_moves=moves,
                          num_turns=turns, converged=idle >= k)
    if not measure_wire:
        return result
    rounds = int(turns)
    return result, WireMeasurement(rounds, rounds * per_turn,
                                   sh.setup_bytes())


def _refine_distributed_traced(problem, assignment,
                               framework=costs.C_FRAMEWORK, num_shards=None,
                               max_turns=512, tol=DEFAULT_TOL, cost_fn="jnp",
                               incremental=True, theta=None,
                               measure_wire=False):
    """Fixed-length traced variant; returns ``(RefineResult, Trace)`` with
    the move sequence of :func:`repro_torch.core.refine.refine_traced`.

    On the incremental path the potentials are initialized once from
    per-shard partials and thereafter updated by the winner's 8-byte
    exact-potential deltas (Thm. 3.1/5.1).  ``incremental=False`` reduces
    the per-turn partials instead.
    """
    sh = _Shards(problem, assignment, num_shards, theta)
    k, dev = sh.k, sh.device
    p = problem
    r, loads = sh.r0, sh.loads0
    idle = _zero(dev)
    rows, per_turn, setup = [], 0, sh.setup_bytes()
    if incremental:
        fused = _fused(cost_fn, False)
        aggs = sh.aggregates(r)
        c0, ct0, init_bytes = sh.potentials(aggs, r, loads)
        setup += init_bytes
    for t in range(max_turns):
        active = idle < k
        machine = t % k
        r_local = sh.r_local(r)
        if incremental:
            dissat, best = sh.reduce(aggs, r_local, loads, framework, fused)
            cands, loc = sh.candidates(dissat, best, r_local, machine)
            dc0s, dct0s = protocol.candidate_deltas(
                aggs, cands, loc, machine, sh.loads_s(loads), sh.speeds_s,
                sh.mu_s, sh.total_s)
            per_turn = _nbytes((cands, dc0s, dct0s))
            winner = protocol.elect(cands, tol)
            moved, delta, r, loads = _sequential_turn(sh, r, loads, winner,
                                                      machine, active)
            aggs = sh.update(aggs, winner.node, delta)
            pick = winner.shard.reshape(1)
            c0 = torch.where(moved, c0 + dc0s.gather(0, pick)[0], c0)
            ct0 = torch.where(moved, ct0 + dct0s.gather(0, pick)[0], ct0)
        else:
            dissat, best = sh.recompute(r, r_local, loads, framework,
                                        cost_fn)
            cands, _ = sh.candidates(dissat, best, r_local, machine)
            winner = protocol.elect(cands, tol)
            moved, _, r, loads = _sequential_turn(sh, r, loads, winner,
                                                  machine, active)
            load_p = sh.load_partials(sh.r_local(r))
            c0, ct0, pot_bytes = sh.potentials(
                sh.aggregates(r), r, torch.sum(load_p, dim=0))
            per_turn = _nbytes((cands, load_p)) + pot_bytes
        idle = torch.where(moved, 0, idle + 1)
        rows.append(_trace_row(moved, winner, machine, c0, ct0, active))
    trace = _stack_trace(rows, dev)
    turns = torch.sum(trace.active.to(torch.int32))
    result = RefineResult(
        assignment=r, loads=loads,
        num_moves=torch.sum(trace.moved.to(torch.int32)), num_turns=turns,
        converged=idle >= k)
    if not measure_wire:
        return result, trace
    rounds = int(turns)
    return result, trace, WireMeasurement(rounds, rounds * per_turn, setup)


def _stack_trace(rows, device) -> Trace:
    if not rows:
        e = torch.zeros(0, device=device)
        i = torch.zeros(0, dtype=torch.int32, device=device)
        b = torch.zeros(0, dtype=torch.bool, device=device)
        return Trace(b, i, i, i, e, e, e, b)
    return Trace(*(torch.stack(col) for col in zip(*rows)))


# ---------------------------------------------------------------------------
# §4.5 simultaneous sweeps, distributed
# ---------------------------------------------------------------------------

def _sweep_candidates(sh: _Shards, dissat, best, r_local):
    v = sh.views
    return protocol.local_candidates_all_machines(
        dissat, best, r_local, v.weights, v.ids, v.valid, sh.k)


def _sweep_apply(sh: _Shards, aggs, r, winners: protocol.Winner):
    """Every shard applies the K elected moves to its block, and the
    mirror takes the moved nodes' new machines."""
    new_aggs = None
    if aggs is not None:
        new_aggs = protocol.update_block_aggregate_sweep(
            aggs.view(-1, sh.k), sh.rows, winners.node, winners.dest,
            winners.moved).view(sh.s, sh.ns, sh.k)
    new_r = agg_mod._set_assignment(r, winners.node, winners.dest,
                                    winners.moved)
    return new_aggs, new_r


def _sweep_outputs(c0s, ct0s, counted: int, max_sweeps: int, device,
                   pad_value=None):
    """The per-sweep potentials padded to ``max_sweeps`` with the last
    values (``pad_value()`` when no sweep ran) and ``active``, True for
    the first ``counted`` sweeps — as ``refine_sweeps`` pads them."""
    if not c0s:
        c0, ct0 = pad_value()
        c0s, ct0s = [c0], [ct0]
    pad = max_sweeps - len(c0s)
    active = torch.arange(max_sweeps, device=device) < counted
    return (torch.stack(c0s + c0s[-1:] * pad),
            torch.stack(ct0s + ct0s[-1:] * pad), active)


def _refine_distributed_simultaneous(problem, assignment,
                                     framework=costs.C_FRAMEWORK,
                                     num_shards=None, max_sweeps=256,
                                     tol=DEFAULT_TOL, cost_fn="jnp",
                                     incremental=True, theta=None,
                                     measure_wire=False):
    """Distributed §4.5 sweeps: each shard ships K candidates per sweep
    (one per machine), elections run per machine, all K moves apply at
    once as a rank-K block-aggregate update.  Exchange per sweep: S*K
    candidates + S load/sq-load/cut partials (or, recomputing, a load
    partial and the C_0/cut pair) — independent of N.  ``num_moves``
    counts actual transfers.  The run stops at the first sweep in which no
    machine moves, and pads the per-sweep outputs as ``refine_sweeps``
    does."""
    sh = _Shards(problem, assignment, num_shards, theta)
    k, dev = sh.k, sh.device
    fused = _fused(cost_fn, False) if incremental else False
    aggs = sh.aggregates(sh.r0) if incremental else None
    r, loads = sh.r0, sh.loads0
    moves = _zero(dev, torch.int64)      # refine_simultaneous's count dtype
    c0s, ct0s, per_sweep, converged = [], [], 0, False
    for _ in range(max_sweeps):
        r_local = sh.r_local(r)
        if incremental:
            dissat, best = sh.reduce(aggs, r_local, loads, framework, fused)
        else:
            dissat, best = sh.recompute(r, r_local, loads, framework,
                                        cost_fn)
        cands = _sweep_candidates(sh, dissat, best, r_local)
        winners = protocol.elect(cands, tol)                      # (K,)
        if not bool(torch.any(winners.moved)):                    # host sync
            converged = True
            break
        aggs, r = _sweep_apply(sh, aggs, r, winners)
        r_local = sh.r_local(r)
        if incremental:
            loads, c0, ct0, parts = sh.closed_potentials(aggs, r_local)
            per_sweep = _nbytes((cands,) + parts)
        else:
            load_p = sh.load_partials(r_local)
            loads = torch.sum(load_p, dim=0)
            c0, ct0, pot_bytes = sh.potentials(sh.aggregates(r), r, loads)
            per_sweep = _nbytes((cands, load_p)) + pot_bytes
        moves = moves + torch.sum(winners.moved.to(torch.int32))
        c0s.append(c0)
        ct0s.append(ct0)
    sweeps = len(c0s)
    outs = _sweep_outputs(
        c0s, ct0s, sweeps, max_sweeps, dev,
        lambda: sh.potentials(sh.aggregates(r), r, loads)[:2])
    result = RefineResult(
        assignment=r, loads=loads, num_moves=moves,
        num_turns=torch.sum(outs[2].to(torch.int32)),
        converged=torch.tensor(converged, device=dev))
    if not measure_wire:
        return result, outs
    return result, outs, WireMeasurement(sweeps, sweeps * per_sweep,
                                         sh.setup_bytes())


# ---------------------------------------------------------------------------
# Fault-injected drivers (DESIGN.md §15)
# ---------------------------------------------------------------------------
#
# The faulty drivers re-run the incremental protocol with a FaultPlan row
# consulted every round: candidates of down / quarantined / undelivered
# shards are masked out of the election, the election prices staleness
# (``protocol.elect_degraded``), omitted broadcasts leave a shard's carried
# aggregate stale, the plan's corruption entries overwrite aggregate
# columns, and its repair schedule rebuilds + column-patches flagged shards
# inside the loop.  The plan lives on the host, so which of these a round
# does is known there; the masks are tensors uploaded once per run.  A
# zero-fault plan reproduces the fault-free drivers bitwise: every degraded
# branch is skipped on a clear plan, and ``elect_degraded`` is
# decision-equivalent to ``elect`` at lag 0.  Each driver ends with an
# oracle audit (``_final_audit``): the worst carried-vs-recomputed
# deviation before and after a final guarded patch of the still-alive
# shards — the public wrappers turn that FaultOutcome into the
# recover-or-raise contract.

def _inf_dev(x: torch.Tensor) -> torch.Tensor:
    """Deviation → finite-or-inf: NaN counts as infinite drift, so a
    ``<= budget`` recovery check can never be satisfied by NaN soup."""
    return torch.nan_to_num(x, nan=float("inf"), posinf=float("inf"))


class _FaultRun:
    """A plan on the host and its device copy, with the per-round steps
    every emulated faulty driver shares."""

    def __init__(self, sh: _Shards, plan: faults.FaultPlan, degraded,
                 msg_bytes: int):
        if plan.num_shards != sh.s:
            raise ValueError(f"fault plan covers {plan.num_shards} shards; "
                             f"the run has {sh.s}")
        self.sh, self.plan = sh, plan
        self.dev = faults.device_plan(plan, sh.device)
        self.rtol = degraded.repair_tol
        self.penalty = degraded.stale_penalty
        self.msg = msg_bytes
        self.extra: list[int] = []       # wire bytes of each round run

    def row(self, t: int) -> int:
        return min(t, self.plan.horizon)

    def inject(self, aggs, i: int, gate):
        """Overwrite column ``corrupt_col`` of flagged shards with
        ``corrupt_val`` (set semantics — a NaN payload lands as NaN)."""
        if not self.plan.corrupt[i].any():
            return aggs
        d = self.dev
        kidx = torch.arange(self.sh.k, device=aggs.device)
        zap = (d.corrupt[i] & gate)[:, None] & (kidx[None, :]
                                                == d.corrupt_col[i][:, None])
        return torch.where(zap[:, None, :], d.corrupt_val[i][:, None, None],
                           aggs)

    def elect(self, cands: protocol.Candidate, i: int, tol):
        p, d = self.plan, self.dev
        blocked = p.down[i] | p.quarantined[i] | ~p.delivered[i]
        if blocked.any():
            mask = d.down[i] | d.quarantined[i] | ~d.delivered[i]
            if cands.gain.ndim == 2:
                mask = mask[:, None]
            cands = cands._replace(
                gain=torch.where(mask, -float("inf"), cands.gain))
        return protocol.elect_degraded(cands, tol, d.lag[i], self.penalty)

    def keep_missed(self, old_aggs, new_aggs, i: int):
        """Shards that miss the broadcast (omit / down) keep their old
        block."""
        if not (self.plan.omit[i] | self.plan.down[i]).any():
            return new_aggs
        miss = self.dev.omit[i] | self.dev.down[i]
        return torch.where(miss[:, None, None], old_aggs, new_aggs)

    def repair_cols(self, aggs, assignment, i: int):
        """Rebuild the oracle aggregates and patch — for the flagged
        shards only — the columns whose carried values deviate beyond
        ``rtol``.  Healthy columns stay bit-identical (the guard is
        NaN-safe)."""
        fresh = self.sh.aggregates(assignment)
        col_dev = torch.max(torch.abs(aggs - fresh), dim=1).values  # (S, K)
        mask = self.dev.repair[i]
        sel = mask[:, None] & ~(col_dev <= self.rtol)
        patched = torch.where(sel[:, None, :], fresh, aggs)
        drift = torch.max(torch.where(mask[:, None], _inf_dev(col_dev),
                                      0.0))
        return patched, drift, torch.sum(sel.to(torch.int32))

    def record(self, i: int) -> None:
        self.extra.append(faults.round_extra_bytes(
            faults.plan_row(self.plan, i), self.msg))

    def extra_bytes(self, rounds: int) -> int:
        return sum(self.extra[:rounds])

    def final_audit(self, aggs, loads, assignment, last_round: int,
                    converged: bool):
        """Post-run oracle audit + unconditional guarded patch.

        ``final_drift`` is the worst carried-vs-recomputed deviation
        (columns and loads, NaN → inf) *before* patching; the patch then
        replaces bad columns of still-alive shards and bad load entries,
        and ``post_drift`` re-measures.  A shard down on the last executed
        round of a non-converged run is dead — its columns stay un-patched
        and the wrapper raises ``DeadShardError``."""
        sh, rtol = self.sh, self.rtol
        last = min(max(last_round, 0), self.plan.horizon)
        dead_row = self.plan.down[last] & (not converged)        # (S,) host
        alive = torch.as_tensor(~dead_row, device=sh.device)
        fresh = sh.aggregates(assignment)
        col_dev = torch.max(torch.abs(aggs - fresh), dim=1).values
        fresh_loads = torch.sum(sh.load_partials(sh.r_local(assignment)),
                                dim=0)
        load_dev = _inf_dev(torch.abs(loads - fresh_loads))
        final_drift = torch.maximum(torch.max(_inf_dev(col_dev)),
                                    torch.max(load_dev))
        sel = alive[:, None] & ~(col_dev <= rtol)
        aggs = torch.where(sel[:, None, :], fresh, aggs)
        loads = torch.where(~(load_dev <= rtol), fresh_loads, loads)
        post_col = torch.max(torch.abs(aggs - fresh), dim=1).values
        post_drift = torch.maximum(
            torch.max(_inf_dev(post_col)),
            torch.max(_inf_dev(torch.abs(loads - fresh_loads))))
        return (aggs, loads, bool(dead_row.any()), final_drift, post_drift,
                torch.sum(sel.to(torch.int32)))


def _stack_ftrace(rows, device) -> FaultTrace:
    if not rows:
        return FaultTrace(torch.zeros(0, dtype=torch.bool, device=device),
                          torch.zeros(0, device=device),
                          torch.zeros(0, dtype=torch.int32, device=device))
    return FaultTrace(*(torch.stack(col) for col in zip(*rows)))


def _refine_distributed_faulty(problem, assignment, fault_plan,
                               framework=costs.C_FRAMEWORK, num_shards=None,
                               max_rounds=10_000, tol=DEFAULT_TOL,
                               cost_fn="jnp",
                               degraded=faults.DEFAULT_DEGRADED, theta=None,
                               measure_wire=False):
    """Fault-injected round-robin driver (incremental protocol only).

    Convergence idles only accumulate on fault-clear rounds (a blocked
    no-move round is not evidence of equilibrium).  Returns ``(result,
    outcome)`` plus a :class:`WireMeasurement` when ``measure_wire``,
    whose payload includes the per-round retry/duplicate/repair bytes."""
    sh = _Shards(problem, assignment, num_shards, theta)
    k, dev = sh.k, sh.device
    fr = _FaultRun(sh, fault_plan, degraded, faults.message_bytes(
        traced=False, simultaneous=False, num_machines=k))
    fused = _fused(cost_fn, True)
    aggs = sh.aggregates(sh.r0)
    r, loads = sh.r0, sh.loads0
    idle, turns, moves = _zero(dev), _zero(dev), _zero(dev)
    repairs, rcols = _zero(dev), _zero(dev)
    rdrift = _zero(dev, torch.float32)
    per_turn = 0
    for t in range(max_rounds):
        if t and t % _SYNC_EVERY == 0 and not bool(idle < k):
            break
        active = idle < k
        i, machine = fr.row(t), t % k
        aggs = fr.inject(aggs, i, active)
        r_local = sh.r_local(r)
        dissat, best = sh.reduce(aggs, r_local, loads, framework, fused)
        cands, _ = sh.candidates(dissat, best, r_local, machine)
        per_turn = _nbytes(cands)
        winner = fr.elect(cands, i, tol)
        moved, delta, r, loads = _sequential_turn(sh, r, loads, winner,
                                                  machine, active)
        aggs = fr.keep_missed(aggs, sh.update(aggs, winner.node, delta), i)
        grow = idle + 1 if fault_plan.clear[i] else idle
        idle = torch.where(moved, 0, grow)
        if fault_plan.repair[i].any():
            patched, rd, rc = fr.repair_cols(aggs, r, i)
            aggs = torch.where(active, patched, aggs)
            repairs = repairs + active.to(torch.int32)
            rcols = rcols + torch.where(active, rc, 0)
            rdrift = torch.maximum(rdrift, torch.where(active, rd, 0.0))
        fr.record(i)
        turns = turns + active.to(torch.int32)
        moves = moves + moved.to(torch.int32)
    rounds = int(turns)
    converged = bool(idle >= k)
    aggs, loads, dead, final_drift, post_drift, fcols = fr.final_audit(
        aggs, loads, r, rounds - 1, converged)
    result = RefineResult(assignment=r, loads=loads, num_moves=moves,
                          num_turns=turns,
                          converged=torch.tensor(converged, device=dev),
                          aggregate_drift=post_drift)
    outcome = faults.FaultOutcome(
        final_drift=final_drift, post_drift=post_drift, dead=dead,
        repairs=repairs, repaired_cols=rcols + fcols,
        max_repair_drift=rdrift)
    if not measure_wire:
        return result, outcome
    return result, outcome, WireMeasurement(
        rounds, rounds * per_turn + fr.extra_bytes(rounds),
        sh.setup_bytes())


def _refine_distributed_traced_faulty(problem, assignment, fault_plan,
                                      framework=costs.C_FRAMEWORK,
                                      num_shards=None, max_rounds=512,
                                      tol=DEFAULT_TOL, cost_fn="jnp",
                                      degraded=faults.DEFAULT_DEGRADED,
                                      theta=None, measure_wire=False):
    """Fault-injected traced driver (incremental protocol only).

    Carried C_0/Ct_0 follow the winner's exact-potential deltas between
    repairs; a repair round recomputes them closed-form from the patched
    aggregates and guard-patches the carried values (relative tolerance,
    so fault-free float noise never triggers a patch).  Returns
    ``(result, trace, ftrace, outcome)`` (+ wire)."""
    sh = _Shards(problem, assignment, num_shards, theta)
    k, dev = sh.k, sh.device
    fr = _FaultRun(sh, fault_plan, degraded, faults.message_bytes(
        traced=True, simultaneous=False, num_machines=k))
    rtol = fr.rtol
    fused = _fused(cost_fn, False)
    r, loads = sh.r0, sh.loads0
    aggs = sh.aggregates(r)
    c0, ct0, init_bytes = sh.potentials(aggs, r, loads)
    idle = _zero(dev)
    zero_f, zero_i = _zero(dev, torch.float32), _zero(dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    rows, frows, per_turn = [], [], 0
    for t in range(max_rounds):
        active = idle < k
        i, machine = fr.row(t), t % k
        aggs = fr.inject(aggs, i, active)
        r_local = sh.r_local(r)
        dissat, best = sh.reduce(aggs, r_local, loads, framework, fused)
        cands, loc = sh.candidates(dissat, best, r_local, machine)
        dc0s, dct0s = protocol.candidate_deltas(
            aggs, cands, loc, machine, sh.loads_s(loads), sh.speeds_s,
            sh.mu_s, sh.total_s)
        per_turn = _nbytes((cands, dc0s, dct0s))
        winner = fr.elect(cands, i, tol)
        moved, delta, r, loads = _sequential_turn(sh, r, loads, winner,
                                                  machine, active)
        aggs = fr.keep_missed(aggs, sh.update(aggs, winner.node, delta), i)
        pick = winner.shard.reshape(1)
        c0 = torch.where(moved, c0 + dc0s.gather(0, pick)[0], c0)
        ct0 = torch.where(moved, ct0 + dct0s.gather(0, pick)[0], ct0)
        grow = idle + 1 if fault_plan.clear[i] else idle
        idle = torch.where(moved, 0, grow)
        rd, rc, did = zero_f, zero_i, false
        if fault_plan.repair[i].any():
            patched, rd, rc = fr.repair_cols(aggs, r, i)
            fl, c0f, ct0f, _ = sh.closed_potentials(patched, sh.r_local(r))

            def guard(x, fresh):
                bad = ~(torch.abs(x - fresh)
                        <= rtol * torch.clamp(torch.abs(fresh), min=1.0))
                return torch.where(bad, fresh, x)

            loads2 = torch.where(~(torch.abs(loads - fl) <= rtol), fl, loads)
            aggs = torch.where(active, patched, aggs)
            loads = torch.where(active, loads2, loads)
            c0 = torch.where(active, guard(c0, c0f), c0)
            ct0 = torch.where(active, guard(ct0, ct0f), ct0)
            rd = torch.where(active, rd, 0.0)
            rc = torch.where(active, rc, 0)
            did = active
        fr.record(i)
        rows.append(_trace_row(moved, winner, machine, c0, ct0, active))
        frows.append((did, rd, rc))
    trace = _stack_trace(rows, dev)
    ftrace = _stack_ftrace(frows, dev)
    turns = torch.sum(trace.active.to(torch.int32))
    rounds = int(turns)
    converged = bool(idle >= k)
    aggs, loads, dead, final_drift, post_drift, fcols = fr.final_audit(
        aggs, loads, r, rounds - 1, converged)
    result = RefineResult(
        assignment=r, loads=loads,
        num_moves=torch.sum(trace.moved.to(torch.int32)), num_turns=turns,
        converged=torch.tensor(converged, device=dev),
        aggregate_drift=post_drift)
    outcome = faults.FaultOutcome(
        final_drift=final_drift, post_drift=post_drift, dead=dead,
        repairs=torch.sum(ftrace.repaired.to(torch.int32)),
        repaired_cols=torch.sum(ftrace.repaired_cols) + fcols,
        max_repair_drift=torch.max(torch.cat([zero_f[None],
                                              ftrace.repair_drift])))
    if not measure_wire:
        return result, trace, ftrace, outcome
    return result, trace, ftrace, outcome, WireMeasurement(
        rounds, rounds * per_turn + fr.extra_bytes(rounds),
        sh.setup_bytes() + init_bytes)


def _refine_distributed_simultaneous_faulty(problem, assignment, fault_plan,
                                            framework=costs.C_FRAMEWORK,
                                            num_shards=None, max_rounds=256,
                                            tol=DEFAULT_TOL, cost_fn="jnp",
                                            degraded=faults.DEFAULT_DEGRADED,
                                            theta=None, measure_wire=False):
    """Fault-injected §4.5 sweep driver (incremental protocol only).

    The sweep can only stop on a fault-clear no-move round — a blocked
    round proves nothing about equilibrium.  Wire counts the executed
    rounds before that stop (``counted = any_move | ~clear``); they form
    a prefix, which keeps the plan-derived ledger
    (``faults.plan_extra_bytes``) byte-exact.  Returns ``(result, (c0s,
    ct0s, counted), ftrace, outcome)`` (+ wire)."""
    sh = _Shards(problem, assignment, num_shards, theta)
    k, dev = sh.k, sh.device
    fr = _FaultRun(sh, fault_plan, degraded, faults.message_bytes(
        traced=False, simultaneous=True, num_machines=k))
    fused = _fused(cost_fn, False)
    r, loads = sh.r0, sh.loads0
    aggs = sh.aggregates(r)
    moves = _zero(dev, torch.int64)      # refine_simultaneous's count dtype
    zero_f, zero_i = _zero(dev, torch.float32), _zero(dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    c0s, ct0s, frows, per_sweep, done = [], [], [], 0, False
    for t in range(max_rounds):
        i = fr.row(t)
        aggs = fr.inject(aggs, i, true)
        r_local = sh.r_local(r)
        dissat, best = sh.reduce(aggs, r_local, loads, framework, fused)
        cands = _sweep_candidates(sh, dissat, best, r_local)
        winners = fr.elect(cands, i, tol)                         # (K,)
        any_move = bool(torch.any(winners.moved))                 # host sync
        new_aggs, new_r = (_sweep_apply(sh, aggs, r, winners) if any_move
                           else (aggs, r))
        aggs = fr.keep_missed(aggs, new_aggs, i)
        r = new_r
        rd, rc, did = zero_f, zero_i, False
        if fault_plan.repair[i].any():
            aggs, rd, rc = fr.repair_cols(aggs, r, i)
            did = True
        loads, c0, ct0, parts = sh.closed_potentials(aggs, sh.r_local(r))
        per_sweep = _nbytes((cands,) + parts)
        if any_move:
            moves = moves + torch.sum(winners.moved.to(torch.int32))
        c0s.append(c0)
        ct0s.append(ct0)
        frows.append((torch.tensor(did, device=dev), rd, rc))
        if not any_move and fault_plan.clear[i]:
            done = True
            break
        fr.record(i)
    # the stopping round is not counted; the rounds after it run nothing
    counted = len(c0s) - done
    outs = _sweep_outputs(c0s, ct0s, counted, max_rounds, dev)
    pad = max_rounds - len(frows)
    frows += [(torch.zeros((), dtype=torch.bool, device=dev), zero_f,
               zero_i)] * pad
    ftrace = _stack_ftrace(frows, dev)
    aggs, loads, dead, final_drift, post_drift, fcols = fr.final_audit(
        aggs, loads, r, max_rounds - 1, done)
    result = RefineResult(
        assignment=r, loads=loads, num_moves=moves,
        num_turns=torch.sum(outs[2].to(torch.int32)),
        converged=torch.tensor(done, device=dev), aggregate_drift=post_drift)
    outcome = faults.FaultOutcome(
        final_drift=final_drift, post_drift=post_drift, dead=dead,
        repairs=torch.sum(ftrace.repaired.to(torch.int32)),
        repaired_cols=torch.sum(ftrace.repaired_cols) + fcols,
        max_repair_drift=torch.max(ftrace.repair_drift))
    if not measure_wire:
        return result, outs, ftrace, outcome
    return result, outs, ftrace, outcome, WireMeasurement(
        counted, counted * per_sweep + fr.extra_bytes(counted),
        sh.setup_bytes())


# ---------------------------------------------------------------------------
# Collective driver: one shard per rank of a torch.distributed group
# ---------------------------------------------------------------------------

def _need_ranks(s: int, have: int) -> ValueError:
    return ValueError(
        f"refine_distributed_shard_map: need {s} devices for {s} shards but "
        f"only {have} are available; run it in a torch.distributed group of "
        f"{s} ranks or use the emulated refine_distributed driver")


@contextlib.contextmanager
def _process_group(device: torch.device, num_shards: int):
    """The rank of this process in the default ``torch.distributed``
    group.  Without one, a group of one rank is made on a ``FileStore``
    (NCCL for a CUDA device, gloo otherwise) and destroyed on exit."""
    import torch.distributed as dist
    own = not dist.is_initialized()
    path = None
    if own:
        if num_shards > 1:
            raise _need_ranks(num_shards, 1)
        fd, path = tempfile.mkstemp(prefix="refine_distributed_store_")
        os.close(fd)
        os.remove(path)
        backend = "nccl" if device.type == "cuda" else "gloo"
        kwargs = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1, **kwargs)
    try:
        world = dist.get_world_size()
        if world < num_shards:
            raise _need_ranks(num_shards, world)
        if world > num_shards:
            raise ValueError(
                f"refine_distributed_shard_map runs one shard per rank; the "
                f"group has {world} ranks for {num_shards} shards")
        yield dist.get_rank()
    finally:
        if own:
            dist.destroy_process_group()
            if os.path.exists(path):
                os.remove(path)


def _gather_candidates(cand: protocol.Candidate, num_shards: int):
    """All-gather every rank's 16-byte candidate: one (4,) int32 message a
    rank (the f32 fields bit-cast), unpacked into an (S,) Candidate.
    Returns the candidates and the gathered buffers' byte size."""
    import torch.distributed as dist
    msg = torch.stack([cand.gain.view(torch.int32), cand.node,
                       cand.dest, cand.weight.view(torch.int32)])
    parts = [torch.empty_like(msg) for _ in range(num_shards)]
    dist.all_gather(parts, msg)
    got = torch.stack(parts)                                 # (S, 4)
    return protocol.Candidate(
        gain=got[:, 0].contiguous().view(torch.float32), node=got[:, 1],
        dest=got[:, 2], weight=got[:, 3].contiguous().view(torch.float32)
    ), _nbytes(parts)


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist
    x = x.clone()
    dist.all_reduce(x, op=op)
    return x


class _Rank:
    """One rank's block of a collective run: its rows, weights, ids, valid
    mask and theta slice, and its (Ns, K) aggregate built from its own
    rows."""

    def __init__(self, problem, views: ShardViews, theta_blocks, rank: int):
        self.rows = views.row_block[rank]                     # (Ns, N)
        self.weights = views.weights[rank].contiguous()
        self.ids = views.ids[rank].contiguous()
        self.valid = views.valid[rank]
        self.theta = (None if theta_blocks is None
                      else theta_blocks[rank].contiguous())
        self.ids_long = self.ids.long()
        self.k = problem.num_machines

    def aggregate(self, assignment) -> torch.Tensor:
        return protocol.block_aggregate(self.rows, assignment, self.k)

    def candidate(self, problem, agg, assignment, loads, total_b,
                  framework: str, machine: int) -> protocol.Candidate:
        """The rank's most dissatisfied ``machine``-owned node, reduced by
        kernel 1 on the card (its twin on the CPU)."""
        r_local = assignment.index_select(0, self.ids_long)
        dissat, best = ops.dissatisfaction_from_aggregate(
            agg, r_local, self.weights, loads, problem.speeds, problem.mu,
            total_b, framework, theta=self.theta)
        cand, _ = protocol.local_candidates(
            dissat[None], best[None], r_local[None], self.weights[None],
            self.ids[None], self.valid[None], machine)
        return protocol.Candidate(*(x[0] for x in cand))


def refine_distributed_shard_map(problem: PartitionProblem, assignment,
                                 framework: str = costs.C_FRAMEWORK,
                                 num_shards: int | None = None,
                                 max_turns: int = 10_000,
                                 tol: float = DEFAULT_TOL,
                                 devices=None, theta=None,
                                 measure_wire: bool = False,
                                 recorder=None, fault_plan=None,
                                 degraded=None):
    """Sequential-turn refinement with each shard on its own rank.

    Every rank of the default ``torch.distributed`` group calls this with
    the same arguments, its problem on its own device.  Rank s holds row
    block s and its (Ns, K) aggregate — built once from its own rows,
    updated by the same rank-1 delta every turn — and reduces it with
    kernel 1 each turn; the 16-byte candidates are exchanged with
    ``all_gather`` (NCCL on the card, gloo on the CPU), and every rank
    elects and applies the identical delta to its replicated mirror.
    Without a group, a group of one rank is made on a ``FileStore`` and
    destroyed before returning (still the collective code path); a group
    of other than ``num_shards`` ranks raises ``ValueError``.
    ``devices``, when given, lists the devices available to the run.

    ``measure_wire=True`` returns ``(result, wire)`` with a
    :class:`WireMeasurement` of the gathered buffers per turn (DESIGN.md
    §14.5).  ``fault_plan`` runs the faulty collective path and returns
    ``(result, report)`` (``(result, wire, report)`` with
    ``measure_wire``).

    ``recorder`` (a :class:`repro_torch.obs.Recorder`) opts into run
    telemetry on rank 0 only: a phase-timed ``run_start``/``wire``/
    ``run_end`` stream (and the fault events of a ``fault_plan`` run),
    the measured bytes reconciled against the analytic ledger.  Every
    rank runs the same protocol, so one rank's stream is the run's; the
    other ranks ignore their ``recorder``.
    """
    s = _resolve_shards(problem, num_shards)
    if devices is not None and len(devices) < s:
        raise _need_ranks(s, len(devices))
    with _process_group(problem.device, s) as rank:
        rec = recorder if rank == 0 else None
        theta_in = theta
        views = build_views(problem, s)
        theta = _resolve_theta(theta, problem)
        theta_blocks = None if theta is None else shard_node_values(theta, s)
        me = _Rank(problem, views, theta_blocks, rank)
        state0 = make_state(problem, assignment)
        total_b = torch.sum(problem.node_weights)
        setup = _nbytes((state0.loads, total_b))
        if fault_plan is not None:
            return _shard_map_faulty_run(
                problem, state0, fault_plan, framework, s, me, rank,
                total_b, max_turns, tol,
                degraded or faults.DEFAULT_DEGRADED, measure_wire, setup,
                rec, theta_in)
        run = None
        if rec is not None:
            run, _ = _open_run(rec, "shard_map", problem, assignment,
                               framework, theta_in, num_shards=s)
        t0 = time.perf_counter()
        with _span(rec, "distributed.shard_map", run):
            result, per_turn = _shard_map_loop(problem, me, state0, total_b,
                                               framework, s, max_turns, tol)
            rounds = (int(result.num_turns) if measure_wire or rec
                      is not None else None)                  # host sync
        wall = time.perf_counter() - t0
        if rounds is None:
            return result
        wire = WireMeasurement(rounds, rounds * per_turn, setup)
        if rec is not None:
            _record_wire(rec, run, problem, s, wire)
            rec.record_result(run, result, wall=wall)
        return (result, wire) if measure_wire else result


def _span(recorder, name: str, run):
    """``recorder.phase(name, run)``, or nothing without a recorder."""
    return (recorder.phase(name, run) if recorder is not None
            else contextlib.nullcontext())


def _shard_map_loop(problem, me: "_Rank", state0, total_b, framework: str,
                    s: int, max_turns: int, tol: float):
    """The collective driver's turns on this rank's block; returns the
    result and the gathered candidates' bytes a turn."""
    k, dev = problem.num_machines, problem.device
    agg = me.aggregate(state0.assignment)
    r, loads = state0.assignment, state0.loads
    idle, turns, moves = _zero(dev), _zero(dev), _zero(dev)
    per_turn = 0
    for t in range(max_turns):
        if t and t % _SYNC_EVERY == 0 and not bool(idle < k):
            break
        active = idle < k
        machine = t % k
        cand = me.candidate(problem, agg, r, loads, total_b, framework,
                            machine)
        cands, per_turn = _gather_candidates(cand, s)
        winner = protocol.elect(cands, tol)
        moved = winner.moved & active
        delta = protocol.move_delta(k, machine, winner.dest, moved,
                                    loads.dtype, dev)
        agg = protocol.update_block_aggregate(agg, me.rows, winner.node,
                                              delta)
        r, loads = protocol.apply_move(r, loads, winner, delta, moved)
        idle = torch.where(moved, 0, idle + 1)
        turns = turns + active.to(torch.int32)
        moves = moves + moved.to(torch.int32)
    result = RefineResult(assignment=r, loads=loads, num_moves=moves,
                          num_turns=turns, converged=idle >= k)
    return result, per_turn


def _shard_map_faulty_run(problem, state0, fault_plan, framework: str,
                          s: int, me: _Rank, rank: int, total_b,
                          max_turns: int, tol: float, degraded,
                          measure_wire: bool, setup: int, recorder=None,
                          theta=None):
    """Collective faulty path (DESIGN.md §15.3): every rank reads the same
    plan; each masks, injects and repairs only its *own* block, the
    outcome scalars reduce with MAX/SUM all-reduces, and the
    recover-or-raise audit is the emulated drivers'.  ``recorder`` is
    rank 0's (``None`` elsewhere); ``theta`` is the caller's, for the
    ``run_start`` event."""
    plan = fault_plan
    if plan.num_shards != s:
        raise ValueError(f"fault plan covers {plan.num_shards} shards; the "
                         f"run has {s}")
    msg = faults.message_bytes(traced=False, simultaneous=False,
                               num_machines=problem.num_machines)
    run = None
    if recorder is not None:
        run, _ = _open_run(recorder, "shard_map", problem,
                           state0.assignment, framework, theta,
                           num_shards=s, faults=True)
    t0 = time.perf_counter()
    with _span(recorder, "distributed.shard_map", run):
        result, outcome, rounds, per_turn, extra = _shard_map_faulty_loop(
            problem, state0, plan, framework, s, me, rank, total_b,
            max_turns, tol, degraded, msg)
    wall = time.perf_counter() - t0
    report = faults.build_report(plan, outcome, rounds,
                                 budget=degraded.repair_tol,
                                 raise_on_failure=False)
    wire = None
    if measure_wire or recorder is not None:
        wire = WireMeasurement(rounds, rounds * per_turn
                               + sum(extra[:rounds]), setup)
    if recorder is not None:
        faults.emit_fault_events(recorder, run, plan, rounds)
        _record_wire(recorder, run, problem, s, wire,
                     fault_extra=faults.plan_extra_bytes(plan, rounds, msg))
        recorder.record_result(run, result, wall=wall,
                               recovered=report.recovered,
                               recovery_drift=report.recovery_drift)
    faults.raise_if_failed(report, budget=degraded.repair_tol)
    if measure_wire:
        return result, wire, report
    return result, report


def _shard_map_faulty_loop(problem, state0, plan, framework: str, s: int,
                           me: _Rank, rank: int, total_b, max_turns: int,
                           tol: float, degraded, msg: int):
    """The faulty collective run's turns and final audit on this rank:
    ``(result, outcome, rounds, candidate bytes a turn, per-round extra
    bytes)``."""
    import torch.distributed as dist
    k, dev = problem.num_machines, problem.device
    dp = faults.device_plan(plan, dev)
    rtol, penalty = degraded.repair_tol, degraded.stale_penalty
    kidx = torch.arange(k, device=dev)
    agg = me.aggregate(state0.assignment)
    r, loads = state0.assignment, state0.loads
    idle, turns, moves = _zero(dev), _zero(dev), _zero(dev)
    repairs, rcols = _zero(dev), _zero(dev)
    rdrift = _zero(dev, torch.float32)
    extra, per_turn = [], 0
    for t in range(max_turns):
        if t and t % _SYNC_EVERY == 0 and not bool(idle < k):
            break
        active = idle < k
        i, machine = min(t, plan.horizon), t % k
        if plan.corrupt[i, rank]:
            zap = (kidx == int(plan.corrupt_col[i, rank])) & active
            agg = torch.where(zap[None, :], dp.corrupt_val[i, rank], agg)
        cand = me.candidate(problem, agg, r, loads, total_b, framework,
                            machine)
        cands, per_turn = _gather_candidates(cand, s)
        blocked = dp.down[i] | dp.quarantined[i] | ~dp.delivered[i]
        cands = cands._replace(gain=torch.where(blocked, -float("inf"),
                                                cands.gain))
        winner = protocol.elect_degraded(cands, tol, dp.lag[i], penalty)
        moved = winner.moved & active
        delta = protocol.move_delta(k, machine, winner.dest, moved,
                                    loads.dtype, dev)
        if not (plan.omit[i, rank] or plan.down[i, rank]):
            agg = protocol.update_block_aggregate(agg, me.rows, winner.node,
                                                  delta)
        r, loads = protocol.apply_move(r, loads, winner, delta, moved)
        idle = torch.where(moved, 0, idle + 1 if plan.clear[i] else idle)
        if plan.repair[i, rank]:
            fresh = me.aggregate(r)
            col_dev = torch.max(torch.abs(agg - fresh), dim=0).values
            colbad = ~(col_dev <= rtol)
            agg = torch.where(active & colbad[None, :], fresh, agg)
            repairs = repairs + active.to(torch.int32)
            rcols = rcols + torch.where(
                active, torch.sum(colbad.to(torch.int32)), 0)
            rdrift = torch.maximum(rdrift, torch.where(
                active, torch.max(_inf_dev(col_dev)), 0.0))
        extra.append(faults.round_extra_bytes(faults.plan_row(plan, i), msg))
        turns = turns + active.to(torch.int32)
        moves = moves + moved.to(torch.int32)
    rounds = int(turns)
    converged = bool(idle >= k)
    last = min(max(rounds - 1, 0), plan.horizon)
    dead_row = plan.down[last] & (not converged)
    fresh = me.aggregate(r)
    col_dev = torch.max(torch.abs(agg - fresh), dim=0).values
    part = protocol.shard_load_partials(
        me.weights[None], me.valid[None], r.index_select(0, me.ids_long)[None],
        k)[0]
    fresh_loads = _all_reduce(part, dist.ReduceOp.SUM)
    load_dev = _inf_dev(torch.abs(loads - fresh_loads))
    final_drift = _all_reduce(torch.maximum(torch.max(_inf_dev(col_dev)),
                                            torch.max(load_dev)),
                              dist.ReduceOp.MAX)
    sel = (not dead_row[rank]) & ~(col_dev <= rtol)
    agg = torch.where(sel[None, :], fresh, agg)
    loads = torch.where(~(load_dev <= rtol), fresh_loads, loads)
    post_col = torch.max(torch.abs(agg - fresh), dim=0).values
    post_drift = _all_reduce(torch.maximum(
        torch.max(_inf_dev(post_col)),
        torch.max(_inf_dev(torch.abs(loads - fresh_loads)))),
        dist.ReduceOp.MAX)
    fcols = _all_reduce(torch.sum(sel.to(torch.int32)), dist.ReduceOp.SUM)
    result = RefineResult(assignment=r, loads=loads, num_moves=moves,
                          num_turns=turns,
                          converged=torch.tensor(converged, device=dev),
                          aggregate_drift=post_drift)
    outcome = faults.FaultOutcome(
        final_drift=final_drift, post_drift=post_drift,
        dead=bool(dead_row.any()),
        repairs=_all_reduce(repairs, dist.ReduceOp.SUM),
        repaired_cols=_all_reduce(rcols, dist.ReduceOp.SUM) + fcols,
        max_repair_drift=_all_reduce(rdrift, dist.ReduceOp.MAX))
    return result, outcome, rounds, per_turn, extra


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _record_wire(recorder, run: str, problem, num_shards: int,
                 wire: WireMeasurement, *, traced: bool = False,
                 simultaneous: bool = False, incremental: bool = True,
                 fault_extra: int = 0) -> None:
    """Reconcile a driver's measured wire counters against the analytic
    ledger for the same executed run and emit the ``wire`` event.
    ``fault_extra`` is the plan-derived retry/repair byte total of a
    fault-injected run (``faults.plan_extra_bytes``)."""
    stats = boundary_stats(problem, num_shards)
    ledger = accounting.ledger_for_run(
        stats, problem.num_machines, int(wire.rounds), traced=traced,
        simultaneous=simultaneous, incremental=incremental,
        fault_bytes=fault_extra)
    recorder.record_wire(run, accounting.reconcile(ledger, wire))


_MODES = {"plain": ("distributed", "distributed.refine"),
          "traced": ("distributed_traced", "distributed.refine_traced"),
          "sweep": ("distributed_sweep", "distributed.refine_simultaneous")}


def _run_faulty_emulated(mode: str, problem, assignment, fault_plan,
                         framework, num_shards, max_rounds: int, tol: float,
                         cost_fn: str, incremental: bool, theta, degraded,
                         measure_wire: bool, recorder=None):
    """Shared recover-or-raise harness behind the three emulated public
    wrappers: run the faulty driver, audit its FaultOutcome into a
    :class:`faults.FaultReport`, stream telemetry when asked, and raise
    the typed error on a dead shard / blown recovery budget."""
    if not incremental:
        raise ValueError(
            "fault injection requires the incremental protocol: the "
            "carried block aggregates are what faults corrupt and what "
            "repair heals (DESIGN.md §15)")
    dm = degraded or faults.DEFAULT_DEGRADED
    s = _resolve_shards(problem, num_shards)
    k = problem.num_machines
    impl = {"plain": _refine_distributed_faulty,
            "traced": _refine_distributed_traced_faulty,
            "sweep": _refine_distributed_simultaneous_faulty}[mode]
    mw = measure_wire or recorder is not None
    run = None
    if recorder is not None:
        run, _ = _open_run(recorder, _MODES[mode][0], problem, assignment,
                           framework, theta, num_shards=s, incremental=True,
                           faults=True)
    t0 = time.perf_counter()
    with _span(recorder, _MODES[mode][1], run):
        out = impl(problem, assignment, fault_plan, framework,
                   num_shards=s, max_rounds=max_rounds, tol=tol,
                   cost_fn=cost_fn, degraded=dm, theta=theta,
                   measure_wire=mw)
        rounds = int(out[0].num_turns)                          # host sync
    wall = time.perf_counter() - t0
    wire = out[-1] if mw else None
    core = out[:-1] if mw else out
    result, outcome = core[0], core[-1]
    extras = core[1:2] if mode != "plain" else ()
    report = faults.build_report(fault_plan, outcome, rounds,
                                 budget=dm.repair_tol,
                                 raise_on_failure=False)
    if recorder is not None:
        _record_faulty(recorder, run, mode, problem, s, fault_plan, core,
                       rounds, wire, report, wall)
    faults.raise_if_failed(report, budget=dm.repair_tol)
    if measure_wire:
        return (result, *extras, wire, report)
    return (result, *extras, report)


def _record_faulty(recorder, run: str, mode: str, problem, s: int, plan,
                   core, rounds: int, wire, report, wall: float) -> None:
    """The events of a fault-injected emulated run: its faults (with the
    traced and sweep drivers' per-round repair side outputs), its turns
    or sweeps, the reconciled wire and the recover-or-raise verdict."""
    k = problem.num_machines
    result = core[0]
    if mode == "plain":
        faults.emit_fault_events(recorder, run, plan, rounds)
    else:
        ftrace = core[2]
        faults.emit_fault_events(recorder, run, plan, rounds,
                                 repair_drift=ftrace.repair_drift,
                                 repaired_cols=ftrace.repaired_cols,
                                 repaired=ftrace.repaired)
    c0, ct0 = _record_moves(recorder, run, mode, problem,
                            core[1] if mode != "plain" else None, rounds)
    _record_wire(recorder, run, problem, s, wire, traced=mode == "traced",
                 simultaneous=mode == "sweep", incremental=True,
                 fault_extra=faults.plan_extra_bytes(
                     plan, rounds, faults.message_bytes(
                         traced=mode == "traced",
                         simultaneous=mode == "sweep", num_machines=k)))
    recorder.record_result(run, result, wall=wall, c0=c0, ct0=ct0,
                           recovered=report.recovered,
                           recovery_drift=report.recovery_drift)


def _record_moves(recorder, run: str, mode: str, problem, outs,
                  rounds: int):
    """The ``turn`` (traced) or ``sweep`` events of a run from its trace
    or per-sweep outputs ``outs``; returns its last potentials (``None``
    for a plain run or one with no rounds)."""
    if mode == "traced":
        recorder.record_trace(run, outs, problem.node_weights,
                              problem.num_machines)
        c0s, ct0s = outs.c0, outs.ct0
    elif mode == "sweep":
        c0s, ct0s, active = outs
        recorder.record_sweeps(run, c0s, ct0s, active)
    if mode == "plain" or not rounds:
        return None, None
    return float(c0s[rounds - 1]), float(ct0s[rounds - 1])


def _recorded(recorder, mode: str, problem, assignment, framework: str,
              num_shards, theta, incremental: bool, driver):
    """A fault-free emulated run under ``recorder``: ``run_start``, the
    timed ``driver(s)`` (which measures its wire), its turns or sweeps,
    the reconciled ``wire`` event and the closing drift + ``run_end``.
    Returns the driver's output, its wire measurement last."""
    s = _resolve_shards(problem, num_shards)
    run, _ = _open_run(recorder, _MODES[mode][0], problem, assignment,
                       framework, theta, num_shards=s,
                       incremental=incremental)
    t0 = time.perf_counter()
    with recorder.phase(_MODES[mode][1], run):
        out = driver(s)
    wall = time.perf_counter() - t0
    result, wire = out[0], out[-1]
    c0, ct0 = _record_moves(recorder, run, mode, problem,
                            out[1] if mode != "plain" else None,
                            int(wire.rounds))
    _record_wire(recorder, run, problem, s, wire, traced=mode == "traced",
                 simultaneous=mode == "sweep", incremental=incremental)
    recorder.record_result(run, result, wall=wall, c0=c0, ct0=ct0)
    return out


def refine_distributed(problem: PartitionProblem, assignment,
                       framework: str = costs.C_FRAMEWORK,
                       num_shards: int | None = None,
                       max_turns: int = 10_000, tol: float = DEFAULT_TOL,
                       cost_fn: str = "jnp",
                       incremental: bool = True,
                       theta=None, measure_wire: bool = False,
                       recorder=None, fault_plan=None, degraded=None):
    """Distributed round-robin refinement (see :func:`_refine_distributed`
    for the protocol); ``num_shards`` defaults to one shard per machine.
    Returns a ``RefineResult`` (``(result, wire)`` with
    ``measure_wire``).

    ``fault_plan`` (a :class:`repro_torch.distributed.faults.FaultPlan`)
    opts into the fault-injected driver under ``degraded``-mode rules
    (DESIGN.md §15): returns ``(result, report[, wire in between])`` with
    a :class:`faults.FaultReport` appended, raising ``DeadShardError`` /
    ``RecoveryFailedError`` when the run cannot recover to the drift
    budget — never silently diverging.

    ``recorder`` (a :class:`repro_torch.obs.Recorder`) opts into run
    telemetry: the run is phase-timed, its measured wire bytes are
    reconciled against ``accounting.ledger_for_run``, and the stream
    closes with drift + ``run_end`` events (a fault-injected run adds its
    fault events and the recover-or-raise verdict).  ``recorder=None``
    runs exactly the recorder-free driver."""
    if fault_plan is not None:
        return _run_faulty_emulated(
            "plain", problem, assignment, fault_plan, framework,
            num_shards, max_turns, tol, cost_fn, incremental, theta,
            degraded, measure_wire, recorder)
    kwargs = dict(max_turns=max_turns, tol=tol, cost_fn=cost_fn,
                  incremental=incremental, theta=theta)
    if recorder is None:
        return _refine_distributed(problem, assignment, framework,
                                   num_shards=num_shards,
                                   measure_wire=measure_wire, **kwargs)
    out = _recorded(recorder, "plain", problem, assignment, framework,
                    num_shards, theta, incremental,
                    lambda s: _refine_distributed(
                        problem, assignment, framework, num_shards=s,
                        measure_wire=True, **kwargs))
    return out if measure_wire else out[0]


def refine_distributed_traced(problem: PartitionProblem, assignment,
                              framework: str = costs.C_FRAMEWORK,
                              num_shards: int | None = None,
                              max_turns: int = 512,
                              tol: float = DEFAULT_TOL,
                              cost_fn: str = "jnp",
                              incremental: bool = True,
                              theta=None, measure_wire: bool = False,
                              recorder=None, fault_plan=None,
                              degraded=None):
    """Traced distributed refinement (see
    :func:`_refine_distributed_traced`): ``(result, trace)``, ``(result,
    trace, wire)`` with ``measure_wire``.  ``fault_plan`` as in
    :func:`refine_distributed` — the return tuple gains a trailing
    :class:`faults.FaultReport`.  ``recorder`` as in
    :func:`refine_distributed`, plus one ``turn`` event per active turn
    (from the returned trace; the carried exact-potential values ride
    along)."""
    if fault_plan is not None:
        return _run_faulty_emulated(
            "traced", problem, assignment, fault_plan, framework,
            num_shards, max_turns, tol, cost_fn, incremental, theta,
            degraded, measure_wire, recorder)
    kwargs = dict(max_turns=max_turns, tol=tol, cost_fn=cost_fn,
                  incremental=incremental, theta=theta)
    if recorder is None:
        return _refine_distributed_traced(problem, assignment, framework,
                                          num_shards=num_shards,
                                          measure_wire=measure_wire,
                                          **kwargs)
    out = _recorded(recorder, "traced", problem, assignment, framework,
                    num_shards, theta, incremental,
                    lambda s: _refine_distributed_traced(
                        problem, assignment, framework, num_shards=s,
                        measure_wire=True, **kwargs))
    return out if measure_wire else out[:2]


def refine_distributed_simultaneous(problem: PartitionProblem, assignment,
                                    framework: str = costs.C_FRAMEWORK,
                                    num_shards: int | None = None,
                                    max_sweeps: int = 256,
                                    tol: float = DEFAULT_TOL,
                                    cost_fn: str = "jnp",
                                    incremental: bool = True,
                                    theta=None, measure_wire: bool = False,
                                    recorder=None, fault_plan=None,
                                    degraded=None):
    """Distributed §4.5 sweeps (see
    :func:`_refine_distributed_simultaneous`): ``(result, (c0s, ct0s,
    active))`` (+ wire).  ``fault_plan`` as in :func:`refine_distributed`
    — the return tuple gains a trailing :class:`faults.FaultReport`.
    ``recorder`` as in :func:`refine_distributed`, plus one ``sweep``
    event per active sweep."""
    if fault_plan is not None:
        return _run_faulty_emulated(
            "sweep", problem, assignment, fault_plan, framework,
            num_shards, max_sweeps, tol, cost_fn, incremental, theta,
            degraded, measure_wire, recorder)
    kwargs = dict(max_sweeps=max_sweeps, tol=tol, cost_fn=cost_fn,
                  incremental=incremental, theta=theta)
    if recorder is None:
        return _refine_distributed_simultaneous(
            problem, assignment, framework, num_shards=num_shards,
            measure_wire=measure_wire, **kwargs)
    out = _recorded(recorder, "sweep", problem, assignment, framework,
                    num_shards, theta, incremental,
                    lambda s: _refine_distributed_simultaneous(
                        problem, assignment, framework, num_shards=s,
                        measure_wire=True, **kwargs))
    return out if measure_wire else out[:2]
