"""Batched ("fleet") execution of the partition game (DESIGN.md §12),
PyTorch port of ``repro.core.batch``.

The paper's claims are statistical — equilibria, potential descent and
load balance over families of topologies, seeds and cost frameworks — so
the unit of execution is a stack of problems.  ``B`` same-shaped problems
(same N and K; adjacency or edge list, node weights, speeds, mu and theta
all varying per element) stack field by field into one problem of the
same type with a leading batch axis, and the batched entry points run all
``B`` refinements together.

``refine_batched`` and ``refine_traced_batched`` (incremental path) run
ONE loop whose carry is the unbatched
:class:`~repro_torch.core.aggregate.AggregateState` with a leading B axis
on every field — aggregate (B, N, K), loads (B, K), assignment (B, N),
potentials (B,).  Each turn reduces the whole stack in one call (kernel 3
on the card by default, :func:`repro_torch.kernels.ops.
make_aggregate_dissat_fn_batched`), picks each element's node, and
applies every element's rank-1 move in one update
(:func:`~repro_torch.core.aggregate.apply_move`).  An element that
has converged is masked — its turns are exact identities, as the
reference's batched ``while_loop`` select-masks it — and the host reads
"all converged" once every ``_SYNC_EVERY`` turns.

Per-element semantics are the looped semantics: every element reproduces
the move sequence, assignment, loads, gains and carried potentials of its
own unbatched run bitwise.  (The reference allows the carried potentials
a last-ULP difference, because XLA may fuse ``c0 + dc0`` differently in
batched layouts; the port runs the same separate ops either way and needs
no such allowance.)  Three things keep that true: the initial carry and
every ``verify_every`` rebuild are built element by element with the
unbatched ``init_aggregate_state``, never with one ``bmm`` whose
summation order may differ from the looped product; each element's
weight sum is its own ``torch.sum``; and every per-turn op is the
unbatched op with a batch axis, with no float atomics.  The per-element
calls read each element through :func:`_element`, which on the card
copies a slice of the stack that starts off a 256-byte boundary: there a
vector that starts off the 16-byte grid is split, and so summed,
differently from a lone problem's.

Stacked problems keep their dataclass type, so ``num_nodes`` and
``num_machines`` read B there; batched code reads N and K from the
trailing dimensions and never calls ``validate()`` on a stack.

The sweep modes (``refine_simultaneous_batched``, ``refine_sweeps_batched``)
and the recompute path (``incremental=False``) run one loop over the stack
as well, as the reference's one vmapped program does.  A sweep reduces the
whole stack in one call and elects, thresholds and counts every element's
movers with the unbatched ops and a batch axis; the host then reads every
element's flag (with the unbounded mode's accepted counts, or the sparse
windows' deepest row group) as one (B,) transfer, and an element whose
flag is down has converged and is left exactly where its own run left it.
The loop stops when no element is left, so it runs max_b sweeps_b sweeps
where a Python loop over the elements would run Σ_b sweeps_b.  What a
stacked call would sum in another order stays element by element: the
closed-form loads and potentials (sums over N and K), the dense rank-R
products of ``apply_moves``, the unbounded mode's rebuilds and every
recomputed aggregate.  Each element draws its acceptance coins from its
own generator, only on the sweeps it is active, in the shape its looped
run draws them.  A sparse fleet's window updates go through one
:func:`~repro_torch.core.aggregate.add_windows` over the (B·N, K) view,
each element's rows offset by b·N, so no window writes another
element's rows and a round with none of an element's rows leaves it
unchanged.

The ``SweepSpec → SweepResult`` runtime lives in
:mod:`repro_torch.sweeps`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels import ops
from . import aggregate as agg_mod
from . import costs
from . import refine as refine_mod
from .problem import PartitionProblem, make_state
from .refine import (_SYNC_EVERY, DEFAULT_TOL, RefineResult, Trace,
                     _adaptive_coin, _assembled_dissat, _mover_buffer,
                     _top_m, _turn_from_cost, _turn_incremental)
from .sparse import SparseProblem, node_incident_edges_batched


# ---------------------------------------------------------------------------
# stacking (DESIGN.md §12.1)
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    """Apply ``fn`` to the tensors of same-structure trees (dataclasses,
    named tuples, tuples, lists), rebuilding the first tree's type.  Any
    other field is static (``SparseProblem.max_degree``) and must agree."""
    first = trees[0]
    if any(type(t) is not type(first) for t in trees[1:]):
        raise ValueError("cannot stack trees of different types: "
                         f"{sorted({type(t).__name__ for t in trees})}")
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(first, (tuple, list)):
        if any(len(t) != len(first) for t in trees[1:]):
            raise ValueError("cannot stack sequences of different lengths")
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    if any(t != first for t in trees[1:]):
        raise ValueError(f"a static field differs across the stack: "
                         f"{[t for t in trees]}")
    return first


def _tensors(tree):
    """The tensors of a tree, in field order."""
    out = []
    _map(lambda t: out.append(t) or t, tree)
    return out


def stack_pytrees(trees: Sequence):
    """Stack same-structure trees of tensors along a new leading batch
    axis.  The result has the SAME type as the inputs, so a stack of
    ``PartitionProblem``\\ s is itself a ``PartitionProblem`` whose tensors
    carry a leading ``(B, ...)`` dimension (DESIGN.md §12.1); static
    fields such as ``SparseProblem.max_degree`` stay plain numbers and
    must agree."""
    trees = list(trees)
    if not trees:
        raise ValueError("cannot stack an empty sequence of pytrees")
    return _map(lambda *leaves: torch.stack(leaves), *trees)


def unstack_pytree(tree, index: int):
    """Element ``index`` of a stacked tree (inverse of one stack slot);
    its tensors are views into the stack."""
    return _map(lambda leaf: leaf[index], tree)


def batch_size(tree) -> int:
    """Leading batch dimension of a stacked tree."""
    return _tensors(tree)[0].shape[0]


def problem_shape_key(problem) -> tuple:
    """The static shape signature a problem must share to stack.

    Dense problems stack by (N, K); sparse ones additionally by their
    padded edge count and ``max_degree`` (DESIGN.md §13.4), the one
    static field of a sparse problem."""
    key: tuple = (type(problem).__name__, problem.num_nodes,
                  problem.num_machines)
    if isinstance(problem, SparseProblem):
        key += (problem.num_edges, problem.max_degree)
    return key


def stack_problems(problems: Sequence[PartitionProblem]) -> PartitionProblem:
    """Stack ``B`` problems (same N, same K) into one batched problem.

    Adjacency (or edge list), node weights, speeds and mu may all differ
    per element; the shapes (and for :class:`SparseProblem`, padded edge
    count + ``max_degree``) must agree (mixed sizes belong in separate
    stacks — :mod:`repro_torch.sweeps` groups by shape).  The stack is
    built on the problems' device; drop the element problems afterwards
    where memory is tight (a dense fleet holds B·N² floats)."""
    problems = list(problems)
    shapes = {problem_shape_key(p) for p in problems}
    if len(shapes) != 1:
        raise ValueError(
            f"stack_problems needs one shape signature, got "
            f"{sorted(shapes)}; group differently-shaped problems into "
            "separate stacks")
    return stack_pytrees(problems)


def shard_across_devices(tree, devices=None):
    """Shard a stacked tree's leading batch axis across devices.

    No-op on a single device or when the batch does not divide the device
    count, as in the reference.  Placing elements on several GPUs waits
    for a machine with several cards to hold it against the one-card
    run; until then a multi-GPU request raises ``NotImplementedError``.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) <= 1 or batch_size(tree) % len(devices) != 0:
        return tree
    raise NotImplementedError(
        "sharding a fleet across several GPUs is not ported yet: its "
        "distributed placement waits for a machine with several cards")


def _stack_theta(theta, num_problems: int, num_nodes: int, device=None):
    """Normalize a per-batch theta spec (scalar, (N,) or (B, N)) to None
    or a (B, N) f32 tensor on ``device``."""
    if theta is None:
        return None
    if not isinstance(theta, torch.Tensor):
        theta = torch.as_tensor(np.asarray(theta, np.float32))
    theta = theta.to(device=device, dtype=torch.float32)
    return theta.expand(num_problems, num_nodes).contiguous()


# Byte boundary an element's tensors start on in the per-element calls on
# the card: its allocator's fresh tensors start on one, and its reductions
# split a vector that starts off the 16-byte grid differently (so sum it
# in another order).  The CPU's per-element calls read views, held bitwise
# to the looped runs by the tests.
_ALIGN = 256


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied if it lies on the card and starts off an
    ``_ALIGN``-byte boundary."""
    if x.device.type != "cuda" or x.data_ptr() % _ALIGN == 0:
        return x
    return x.clone()


def _element(problems, b: int):
    """Element b of a stacked problem for the per-element calls (each
    element's weight sum, closed forms, products and rebuilds): views into
    the stack, each through :func:`_aligned`, so those calls sum as a lone
    problem's do."""
    return _map(lambda leaf: _aligned(leaf[b]), problems)


def _prepare(problems, assignments, theta):
    """The element problems (:func:`_element`), the (B, N) int32
    assignments and the (B, N) theta or None, all on the stack's
    device."""
    dev = problems.device
    if isinstance(assignments, torch.Tensor):
        r0 = assignments.to(device=dev, dtype=torch.int32)
    else:
        r0 = torch.as_tensor(np.asarray(assignments, np.int32), device=dev)
    bsz, n = r0.shape
    elements = [_element(problems, b) for b in range(bsz)]
    return elements, r0, _stack_theta(theta, bsz, n, dev)


def _init_carry(elements, r0):
    """The fleet's carry, built element by element with the unbatched
    ``init_aggregate_state`` (never one ``bmm``), and each element's own
    weight sum."""
    carry = stack_pytrees([agg_mod.init_aggregate_state(p, r0[b])
                           for b, p in enumerate(elements)])
    total_b = torch.stack([torch.sum(p.node_weights) for p in elements])
    return carry, total_b


def _resync(elements, carry, max_drift, live: list[bool]):
    """``verify_every`` over a fleet: rebuild the carry of every element
    with ``live[b]`` by the unbatched :func:`~repro_torch.core.aggregate.
    resync` and fold its drift in; the others keep their carry bitwise
    (a looped run stops at its first boundary after converging)."""
    states, drifts = [], []
    for b, p in enumerate(elements):
        state, drift = unstack_pytree(carry, b), max_drift[b]
        if live[b]:
            state, observed = agg_mod.resync(p, state)
            drift = torch.maximum(drift, observed)
        states.append(state)
        drifts.append(drift)
    return stack_pytrees(states), torch.stack(drifts)


# ---------------------------------------------------------------------------
# batched refinement entry points
# ---------------------------------------------------------------------------

def refine_batched(problems, assignments,
                   framework: str = costs.C_FRAMEWORK,
                   max_turns: int = 10_000, tol: float = DEFAULT_TOL,
                   incremental: bool = True, verify_every: int = 0,
                   dissat_fn=None, theta=None) -> RefineResult:
    """:func:`repro_torch.core.refine.refine` over a problem stack
    (DESIGN.md §12).

    ``problems`` is a stacked problem (:func:`stack_problems`),
    ``assignments`` is (B, N) and ``theta`` is ``None`` or broadcastable
    to (B, N).  Returns a ``RefineResult`` whose tensors carry a leading
    batch axis; each element equals its unbatched run bitwise, with
    ``num_turns`` counting that element's active turns.  ``dissat_fn``
    follows the 9-argument convention with a batch axis on every operand
    (``mu`` and ``total_weight`` (B,)); the default is kernel 3 on the
    card and its twin on the CPU
    (:func:`~repro_torch.kernels.ops.make_aggregate_dissat_fn_batched`).
    ``verify_every=M`` rebuilds the carry of every still-active element
    every M turns.  ``incremental=False`` runs the recompute path as the
    same one loop: each turn rebuilds the aggregate of every element not
    yet seen converged by its own product, as the unbatched turn does.
    """
    elements, r0, theta = _prepare(problems, assignments, theta)
    if not incremental:
        return _refine_recompute(problems, elements, r0, framework,
                                 max_turns, tol, theta)
    if dissat_fn is None:
        dissat_fn = ops.make_aggregate_dissat_fn_batched()
    bsz = r0.shape[0]
    k = problems.speeds.shape[-1]
    dev = r0.device
    carry, total_b = _init_carry(elements, r0)
    idle, turns, moves = (torch.zeros(bsz, dtype=torch.int32, device=dev)
                          for _ in range(3))
    max_drift = torch.zeros(bsz, device=dev)
    for t in range(max_turns):
        if t and t % _SYNC_EVERY == 0 and not bool((idle < k).any()):
            break
        active = idle < k
        carry, res, _ = _turn_incremental(problems, carry, t % k,
                                          framework, tol, total_b,
                                          dissat_fn, theta, active)
        idle = torch.where(res.moved, 0, idle + 1)
        turns = turns + active.to(torch.int32)
        moves = moves + res.moved.to(torch.int32)
        if verify_every and (t + 1) % verify_every == 0:
            live = active.tolist()                  # host sync
            if not any(live):
                break
            carry, max_drift = _resync(elements, carry, max_drift, live)
    return RefineResult(assignment=carry.assignment, loads=carry.loads,
                        num_moves=moves, num_turns=turns,
                        converged=idle >= k, aggregate_drift=max_drift)


def refine_traced_batched(problems, assignments,
                          framework: str = costs.C_FRAMEWORK,
                          max_turns: int = 512, tol: float = DEFAULT_TOL,
                          incremental: bool = True, verify_every: int = 0,
                          theta=None):
    """:func:`repro_torch.core.refine.refine_traced` over a problem stack.

    Returns ``(RefineResult, Trace)`` with a leading batch axis on every
    tensor: ``Trace.moved`` is (B, T), etc.  The incremental path runs one
    loop with the looped run's assembly-then-reduce reduction
    (``_assembled_dissat``) over the whole stack and resyncs every element
    at every ``verify_every`` boundary, as each looped run does; each
    element's trace, result and carried potentials equal its looped run
    bitwise.  ``incremental=False`` runs the recompute path as the same
    one loop, every element's aggregate and potentials rebuilt every turn
    by its own products, as the unbatched traced loop does.
    """
    elements, r0, theta = _prepare(problems, assignments, theta)
    bsz = r0.shape[0]
    k = problems.speeds.shape[-1]
    dev = r0.device
    if incremental:
        carry, total_b = _init_carry(elements, r0)
    else:
        carry, total_b = _recompute_carry(elements, r0)
        aggregate = None
    idle = torch.zeros(bsz, dtype=torch.int32, device=dev)
    max_drift = torch.zeros(bsz, device=dev)
    rows = []
    for t in range(max_turns):
        active = idle < k
        if incremental:
            carry, res, _ = _turn_incremental(problems, carry, t % k,
                                              framework, tol, total_b,
                                              _assembled_dissat, theta,
                                              active)
            c0, ct0 = carry.c0, carry.ct0
        else:
            aggregate = _aggregates(elements, carry.assignment, aggregate,
                                    [True] * bsz)
            carry, res, _ = _turn_from_cost(
                problems, carry, _fleet_costs(problems, carry, aggregate,
                                              framework, total_b),
                t % k, tol, theta, active)
            c0 = torch.stack([costs.global_cost_c0(p, carry.assignment[b])
                              for b, p in enumerate(elements)])
            ct0 = torch.stack([costs.global_cost_ct0(p, carry.assignment[b])
                               for b, p in enumerate(elements)])
        idle = torch.where(res.moved, 0, idle + 1)
        if incremental and verify_every and (t + 1) % verify_every == 0:
            carry, max_drift = _resync(elements, carry, max_drift,
                                       [True] * bsz)
            c0, ct0 = carry.c0, carry.ct0
        rows.append((res.moved, res.node, res.source, res.dest, res.gain,
                     c0, ct0, active))
    trace = Trace(*(torch.stack(col, dim=1) for col in zip(*rows)))
    result = RefineResult(
        assignment=carry.assignment, loads=carry.loads,
        num_moves=torch.sum(trace.moved.to(torch.int32), dim=1),
        num_turns=torch.sum(trace.active.to(torch.int32), dim=1),
        converged=idle >= k, aggregate_drift=max_drift)
    return result, trace


def refine_simultaneous_batched(problems, assignments,
                                framework: str = costs.C_FRAMEWORK,
                                max_sweeps: int = 256,
                                tol: float = DEFAULT_TOL, theta=None):
    """§4.5 simultaneous-sweep mode over a problem stack (DESIGN.md §12):
    one loop over the stack, each element bitwise its unbatched
    :func:`~repro_torch.core.refine.refine_simultaneous` (the degenerate
    setting of :func:`refine_sweeps_batched`).

    Returns ``(RefineResult, (c0s, ct0s, active))`` with leading batch
    axes (the per-sweep potential traces are (B, max_sweeps), each
    element's padded after its last sweep as its looped run pads them)."""
    return _refine_sweeps_fleet(problems, assignments, framework,
                                max_sweeps, tol, theta)


def refine_sweeps_batched(problems, assignments,
                          framework: str = costs.C_FRAMEWORK,
                          max_sweeps: int = 256, tol: float = DEFAULT_TOL,
                          theta=None, moves_per_machine: int | None = 1,
                          move_prob: float = 1.0, epsilon: float = 0.0,
                          generators: Sequence[torch.Generator] | None = None):
    """:func:`repro_torch.core.refine.refine_sweeps` over a problem stack
    (DESIGN.md §17): multi-move probabilistic sweep fleets in one loop
    over the stack, one host read a fleet sweep (two in the unbounded
    mode's mover-buffer sweeps of a sparse fleet, the second
    ``add_windows``' depth), each element bitwise its looped run.

    ``generators`` is a (B,) sequence of ``torch.Generator`` on the
    problems' device, one per element, required exactly when
    ``move_prob < 1``; element b draws its coins from ``generators[b]``
    alone and only on the sweeps it is active, so its coin sequence and
    its generator's final state are those of its looped run.  The sweep
    configuration is shared across the batch, like ``framework``;
    ``epsilon``'s threshold is each element's own.  Returns
    ``(RefineResult, (c0s, ct0s, active))`` with leading batch axes."""
    if move_prob < 1.0:
        if generators is None:
            raise ValueError("refine_sweeps_batched(move_prob < 1) needs a "
                             "(B,) sequence of torch.Generator "
                             "`generators`, one per element")
    bsz = np.shape(assignments)[0]
    if generators is not None and len(generators) != bsz:
        raise ValueError(f"got {len(generators)} generators for "
                         f"{bsz} elements")
    return _refine_sweeps_fleet(problems, assignments, framework,
                                max_sweeps, tol, theta, moves_per_machine,
                                move_prob, epsilon, generators)


# ---------------------------------------------------------------------------
# the one loop of the sweep modes
# ---------------------------------------------------------------------------

def _refine_sweeps_fleet(problems, assignments, framework: str,
                         max_sweeps: int, tol: float, theta,
                         moves_per_machine: int | None = 1,
                         move_prob: float = 1.0, epsilon: float = 0.0,
                         generators=None):
    """:func:`~repro_torch.core.refine._refine_sweeps` over a stack: the
    same sweep body with a batch axis, ``live`` (the host's list of the
    elements still sweeping) and ``active`` (its device copy) masking the
    elements that have converged."""
    costs.is_sparse(problems)       # TypeError for anything else
    elements, r0, theta = _prepare(problems, assignments, theta)
    bsz, n = r0.shape
    k = problems.speeds.shape[-1]
    dev = r0.device
    sparse = costs.is_sparse(problems)
    elected = moves_per_machine == 1
    unbounded = moves_per_machine is None
    carry, total_b = _init_carry(elements, r0)
    sq_weights = [p.node_weights * p.node_weights for p in elements]
    kidx = torch.arange(k, device=dev)
    live = [True] * bsz
    converged = [False] * bsz
    active = torch.ones(bsz, dtype=torch.bool, device=dev)
    moves = torch.zeros(bsz, dtype=torch.int64, device=dev)
    c0s, ct0s, actives = [], [], []
    for _ in range(max_sweeps):
        if epsilon:
            pot = carry.c0 if framework == costs.C_FRAMEWORK else carry.ct0
            thresh = (tol + epsilon * torch.abs(pot) / n)[:, None]
        else:
            thresh = tol
        dissat, best = refine_mod._assembled_dissat(
            carry.aggregate, carry.assignment, problems.node_weights,
            carry.loads, problems.speeds, problems.mu, framework, total_b,
            theta)
        if unbounded:
            nodes, dest, cand = None, best, dissat > thresh
        else:
            owned = carry.assignment.long()[:, None, :] == kidx[:, None]
            masked = torch.where(owned, dissat[:, None, :],
                                 -float("inf"))              # (B, K, N)
            if elected:
                # the most dissatisfied owned node (first maximum)
                nodes = torch.argmax(masked, dim=-1)
                gains = torch.max(masked, dim=-1).values
            else:
                gains, nodes = _top_m(masked.reshape(bsz * k, n),
                                      moves_per_machine)
                gains = gains.reshape(bsz, -1)
                nodes = nodes.reshape(bsz, -1)
            dest = best.gather(1, nodes)
            cand = gains > thresh
        cand = cand & active[:, None]
        if move_prob < 1.0:
            cand, coin = _fleet_coins(elements, carry, best, cand, live,
                                      move_prob, generators, unbounded)
            accept = cand & coin
        else:
            accept = cand
        any_cand = torch.any(cand, dim=1)
        n_acc = torch.sum(accept.to(torch.int32), dim=1)
        read = [any_cand.to(torch.int64)]
        if unbounded:
            read.append(n_acc)
        elif sparse:
            rows, contrib = _fleet_windows(problems, carry.assignment,
                                           nodes, dest, accept)
            plan = agg_mod.plan_windows(bsz * n, rows, contrib)
            read.append(agg_mod.window_depth(plan, bsz * n)[None])
        # host sync: every element's flag, with its accepted count
        # (unbounded) or the windows' deepest row group (sparse), at once
        vals = torch.cat(read).tolist()
        doing = {b for b in range(bsz) if live[b] and vals[b]}
        for b in range(bsz):
            converged[b] = converged[b] or (live[b] and not vals[b])
        live = [b in doing for b in range(bsz)]
        if not doing:
            break
        active = active & any_cand
        if unbounded:
            carry = _apply_unbounded(problems, elements, sq_weights, carry,
                                     accept, best, n_acc, vals[bsz:], doing,
                                     total_b)
        else:
            if sparse:
                aggregate = agg_mod.apply_windows(
                    carry.aggregate.reshape(bsz * n, k), plan,
                    vals[bsz]).reshape(bsz, n, k)
            elif elected:
                aggregate = torch.where(
                    active[:, None, None],
                    _sweep_columns(problems.adjacency, carry.aggregate,
                                   nodes, dest, accept), carry.aggregate)
            else:
                aggregate = _products(elements, carry, {
                    b: (nodes[b], dest[b], accept[b]) for b in doing})
            carry = _closed_forms(elements, sq_weights, carry, aggregate,
                                  _set_assignments(carry.assignment, nodes,
                                                   dest, accept),
                                  total_b, doing)
        moves = moves + n_acc
        c0s.append(carry.c0)
        ct0s.append(carry.ct0)
        actives.append(active)
    pad = max_sweeps - len(actives)
    c0s += [carry.c0] * pad
    ct0s += [carry.ct0] * pad
    actives += [torch.zeros(bsz, dtype=torch.bool, device=dev)] * pad
    active = torch.stack(actives, dim=1)
    result = RefineResult(
        assignment=carry.assignment, loads=carry.loads, num_moves=moves,
        num_turns=torch.sum(active.to(torch.int32), dim=1),
        converged=torch.tensor(converged, device=dev),
        aggregate_drift=torch.zeros(bsz, device=dev))
    return result, (torch.stack(c0s, dim=1), torch.stack(ct0s, dim=1),
                    active)


def _fleet_coins(elements, carry, best, cand, live: list[bool],
                 move_prob: float, generators, unbounded: bool):
    """``(cand, coin)`` for a sweep of a fleet: each live element draws
    its coins from its own generator in the shape its looped run draws
    them (the unbounded mode's adaptive coin also drops candidates); the
    others draw nothing."""
    cands, coins = [], []
    for b, p in enumerate(elements):
        c = cand[b]
        if not live[b]:
            coin = torch.zeros_like(c)
        elif unbounded:
            coin, c = _adaptive_coin(unstack_pytree(carry, b), p, best[b], c,
                                     move_prob, generators[b])
        else:
            coin = torch.rand(c.shape, generator=generators[b],
                              device=c.device) < move_prob
        cands.append(c)
        coins.append(coin)
    return torch.stack(cands), torch.stack(coins)


def _fleet_windows(problems, assignment, nodes, dests, will_move):
    """The (rows, contributions) of R moves in every element of a sparse
    fleet, for one :func:`~repro_torch.core.aggregate.add_windows` over
    the (B·N, K) view: element b's rows offset by b·N, each element's
    windows in its looped run's (r, d) order, masked slots zero."""
    bsz, n = assignment.shape
    k = problems.speeds.shape[-1]
    dt = problems.node_weights.dtype
    nodes = nodes.long()
    sources = assignment.gather(1, nodes).long()
    kidx = torch.arange(k, device=assignment.device)
    col_delta = (dests.long()[..., None] == kidx).to(dt) \
        - (sources[..., None] == kidx).to(dt)                 # (B, R, K)
    nbrs, ws = node_incident_edges_batched(problems, nodes)   # (B, R, D)
    ws = ws * will_move.to(dt)[:, :, None]
    contrib = ws[..., None] * col_delta[:, :, None, :]       # (B, R, D, K)
    rows = nbrs + n * torch.arange(bsz, device=nbrs.device)[:, None, None]
    return rows.reshape(-1), contrib.reshape(-1, k)


def _sweep_columns(adjacency, aggregate, picks, dests, will_move):
    """:func:`~repro_torch.core.aggregate.apply_sweep`'s dense rank-K
    update with a batch axis: the same elementwise ops, duplicate
    destinations summed in machine order."""
    bsz, n, k = aggregate.shape
    dt = aggregate.dtype
    mask = will_move.to(dt)                                    # (B, K)
    kidx = torch.arange(k, device=aggregate.device)
    dest_hot = (dests.long()[:, :, None] == kidx).to(dt)       # (B, K, K)
    cols = adjacency.gather(2, picks[:, None, :].expand(bsz, n, k)) \
        * mask[:, None, :]
    out = aggregate - cols                                     # sources
    for m in range(k):
        out = out + cols[:, :, m:m + 1] * dest_hot[:, m][:, None, :]
    return out


def _set_assignments(assignment, nodes, dests, will_move):
    """The (B, N) ``assignment`` with each element's ``nodes[b, r]`` set
    to ``dests[b, r]`` where ``will_move[b, r]``; masked writes go to a
    scratch slot and are dropped."""
    bsz, n = assignment.shape
    offsets = n * torch.arange(bsz, device=assignment.device)[:, None]
    safe = torch.where(will_move, nodes.long() + offsets, bsz * n)
    out = torch.cat([assignment.reshape(-1), assignment.new_zeros(1)])
    out[safe.reshape(-1)] = dests.to(assignment.dtype).reshape(-1)
    return out[:bsz * n].view(bsz, n)


def _products(elements, carry, moves: dict):
    """The (B, N, K) aggregate after each element b in ``moves`` applies
    its ``(nodes, dests, will_move)`` by ``apply_moves``' dense (N, R) @
    (R, K) product, with its own R (a batched or padded product would
    sum in another order); the others keep theirs."""
    return torch.stack([
        agg_mod.moves_aggregate(elements[b], carry.aggregate[b],
                                carry.assignment[b], *moves[b])
        if b in moves else carry.aggregate[b]
        for b in range(len(elements))])


def _closed_forms(elements, sq_weights, carry, aggregate, assignment,
                  total_b, doing, rebuilt=None):
    """The fleet's carry after a sweep: ``aggregate`` and ``assignment``,
    and for each element in ``doing`` the loads and potentials of
    ``apply_moves``' closed forms (``machine_loads``, ``cut_from_aggregate``,
    ``potentials_closed_form``).  Their elementwise parts run over the
    stack; each sum over N or K and each one-hot product is the element's
    own call on an aligned input, as its looped run's is.  Elements in
    ``rebuilt`` take that state; the others keep their carry."""
    rebuilt = rebuilt or {}
    idx = [b for b in sorted(doing) if b not in rebuilt]
    rows = {b: (st.loads, st.c0, st.ct0) for b, st in rebuilt.items()}
    if idx:
        k = aggregate.shape[-1]
        kidx = torch.arange(k, device=aggregate.device)
        onehot = (assignment.long()[..., None] == kidx).to(aggregate.dtype)
        degree = costs.row_sum(aggregate)[..., 0]               # (B, N)
        internal = aggregate.gather(-1, assignment.long()[..., None])[..., 0]
        loads, sq_loads, deg, own = [], [], [], []
        for b in idx:
            hot = _aligned(onehot[b])
            loads.append(elements[b].node_weights @ hot)
            sq_loads.append(sq_weights[b] @ hot)
            deg.append(torch.sum(_aligned(degree[b])))
            own.append(torch.sum(_aligned(internal[b])))
        loads, sq_loads = torch.stack(loads), torch.stack(sq_loads)
        cut = 0.5 * (torch.stack(deg) - torch.stack(own))
        speeds = torch.stack([elements[b].speeds for b in idx])
        mu = torch.stack([elements[b].mu for b in idx])
        total = torch.stack([total_b[b] for b in idx])
        c_terms = (loads * loads - sq_loads) / speeds
        dev = loads / speeds - total[:, None]
        ct_terms = dev * dev
        c0 = torch.stack([torch.sum(_aligned(t)) for t in c_terms]) \
            + mu * cut
        ct0 = torch.stack([torch.sum(_aligned(t)) for t in ct_terms]) \
            + 0.5 * mu * cut
        rows.update((b, (loads[j], c0[j], ct0[j])) for j, b in enumerate(idx))

    def field(i, old):
        return torch.stack([rows[b][i] if b in rows else old[b]
                            for b in range(len(elements))])

    if rebuilt:
        aggregate = torch.stack([rebuilt[b].aggregate if b in rebuilt
                                 else aggregate[b]
                                 for b in range(len(elements))])
        assignment = torch.stack([rebuilt[b].assignment if b in rebuilt
                                  else assignment[b]
                                  for b in range(len(elements))])
    return agg_mod.AggregateState(
        assignment=assignment, loads=field(0, carry.loads),
        aggregate=aggregate, c0=field(1, carry.c0), ct0=field(2, carry.ct0))


def _apply_unbounded(problems, elements, sq_weights, carry, accept, best,
                     n_acc, counts: list[int], doing: set, total_b):
    """An unbounded sweep's updates: per element, as its looped run
    chooses by its accepted count, the mover buffer or the O(E·K)
    rebuild.  The buffers are one buffer of the largest count among the
    buffered elements; a sparse fleet's windows go through one
    ``add_windows`` (which reads its depth back), a dense element's
    product takes its own count's slots (:func:`_products`)."""
    bsz, n, k = carry.aggregate.shape
    cap = min(refine_mod._UNBOUNDED_APPLY_CAP, n)
    rebuilt = {b: agg_mod.rebuild_state(
        elements[b], torch.where(accept[b], best[b], carry.assignment[b]),
        total_b[b]) for b in doing if counts[b] > cap}
    buffered = {b for b in doing if counts[b] <= cap}
    aggregate, assignment = carry.aggregate, carry.assignment
    size = max((counts[b] for b in buffered), default=0)
    if size:
        idx = _mover_buffer(accept, size)                      # (B, size)
        slots = torch.arange(size, device=idx.device)
        valid = (slots < n_acc[:, None]) & (n_acc <= cap)[:, None]
        dests = best.gather(1, idx)
        if costs.is_sparse(problems):
            rows, contrib = _fleet_windows(problems, assignment, idx, dests,
                                           valid)
            aggregate = agg_mod.add_windows(
                aggregate.reshape(bsz * n, k), rows,
                contrib).reshape(bsz, n, k)
        else:
            aggregate = _products(elements, carry, {
                b: (idx[b, :counts[b]], dests[b, :counts[b]],
                    valid[b, :counts[b]]) for b in buffered})
        assignment = _set_assignments(assignment, idx, dests, valid)
    return _closed_forms(elements, sq_weights, carry, aggregate, assignment,
                         total_b, buffered, rebuilt)


# ---------------------------------------------------------------------------
# the one loop of the recompute path
# ---------------------------------------------------------------------------

def _recompute_carry(elements, r0):
    """The recompute path's fleet state (assignments and each element's
    loads by the unbatched ``make_state``) and each element's weight
    sum."""
    state = stack_pytrees([make_state(p, r0[b])
                           for b, p in enumerate(elements)])
    total_b = torch.stack([torch.sum(p.node_weights) for p in elements])
    return state, total_b


def _aggregates(elements, assignment, previous, live: list[bool]):
    """Every live element's (N, K) aggregate rebuilt from its adjacency or
    edge list by its own product, as the unbatched recompute turn builds
    it; the others keep ``previous`` (their turns are masked)."""
    return torch.stack([
        costs.problem_aggregate(p, assignment[b], p.num_machines)
        if live[b] else previous[b] for b, p in enumerate(elements)])


def _fleet_costs(problems, state, aggregate, framework: str, total_b):
    """The (B, N, K) cost matrices of the recompute turn from each
    element's recomputed aggregate (``costs.cost_matrix``'s assembly with
    a batch axis)."""
    return costs.cost_matrix_from_aggregate(
        aggregate, state.assignment, problems.node_weights, state.loads,
        problems.speeds, problems.mu, framework, total_weight=total_b)


def _refine_recompute(problems, elements, r0, framework: str,
                      max_turns: int, tol: float, theta) -> RefineResult:
    """``refine_batched(incremental=False)``: the incremental path's loop
    (``_SYNC_EVERY`` reads, masked turns) on the recompute turn.  An
    element the host has seen converged keeps its last aggregate."""
    bsz = r0.shape[0]
    k = problems.speeds.shape[-1]
    dev = r0.device
    state, total_b = _recompute_carry(elements, r0)
    aggregate = None
    live = [True] * bsz
    idle, turns, moves = (torch.zeros(bsz, dtype=torch.int32, device=dev)
                          for _ in range(3))
    for t in range(max_turns):
        if t and t % _SYNC_EVERY == 0:
            live = (idle < k).tolist()              # host sync
            if not any(live):
                break
        active = idle < k
        aggregate = _aggregates(elements, state.assignment, aggregate, live)
        state, res, _ = _turn_from_cost(
            problems, state, _fleet_costs(problems, state, aggregate,
                                          framework, total_b),
            t % k, tol, theta, active)
        idle = torch.where(res.moved, 0, idle + 1)
        turns = turns + active.to(torch.int32)
        moves = moves + res.moved.to(torch.int32)
    return RefineResult(assignment=state.assignment, loads=state.loads,
                        num_moves=moves, num_turns=turns,
                        converged=idle >= k,
                        aggregate_drift=torch.zeros(bsz, device=dev))
