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
unbatched op with a batch axis, with no float atomics.

Stacked problems keep their dataclass type, so ``num_nodes`` and
``num_machines`` read B there; batched code reads N and K from the
trailing dimensions and never calls ``validate()`` on a stack.

Run element by element (one unbatched run each, results stacked):
the recompute path (``incremental=False``, which has no batched kernel in
the reference either), ``refine_simultaneous_batched`` and
``refine_sweeps_batched``.  The sweep modes read counts back per element
(the unbounded mode's mover count and ``add_windows``' depth) and each
element exits on its own sweep, so one loop would wait on the slowest
element's reads; their per-element semantics are those of
:func:`~repro_torch.core.refine.refine_sweeps`.

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
from .problem import PartitionProblem
from .refine import (_SYNC_EVERY, DEFAULT_TOL, RefineResult, Trace,
                     _assembled_dissat, _turn_incremental, refine,
                     refine_simultaneous, refine_sweeps, refine_traced)
from .sparse import SparseProblem


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


def _prepare(problems, assignments, theta):
    """The element problems (views into the stack), the (B, N) int32
    assignments and the (B, N) theta or None, all on the stack's
    device."""
    dev = problems.device
    if isinstance(assignments, torch.Tensor):
        r0 = assignments.to(device=dev, dtype=torch.int32)
    else:
        r0 = torch.as_tensor(np.asarray(assignments, np.int32), device=dev)
    bsz, n = r0.shape
    elements = [unstack_pytree(problems, b) for b in range(bsz)]
    return elements, r0, _stack_theta(theta, bsz, n, dev)


def _row(theta, b: int):
    return None if theta is None else theta[b]


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
    every M turns.  ``incremental=False`` runs element by element through
    the unbatched recompute path.
    """
    elements, r0, theta = _prepare(problems, assignments, theta)
    if not incremental:
        return stack_pytrees([
            refine(p, r0[b], framework, max_turns=max_turns, tol=tol,
                   incremental=False, theta=_row(theta, b))
            for b, p in enumerate(elements)])
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
    bitwise.  ``incremental=False`` runs element by element.
    """
    elements, r0, theta = _prepare(problems, assignments, theta)
    if not incremental:
        return stack_pytrees([
            refine_traced(p, r0[b], framework, max_turns=max_turns, tol=tol,
                          incremental=False, theta=_row(theta, b))
            for b, p in enumerate(elements)])
    bsz = r0.shape[0]
    k = problems.speeds.shape[-1]
    dev = r0.device
    carry, total_b = _init_carry(elements, r0)
    idle = torch.zeros(bsz, dtype=torch.int32, device=dev)
    max_drift = torch.zeros(bsz, device=dev)
    rows = []
    for t in range(max_turns):
        active = idle < k
        carry, res, _ = _turn_incremental(problems, carry, t % k,
                                          framework, tol, total_b,
                                          _assembled_dissat, theta, active)
        idle = torch.where(res.moved, 0, idle + 1)
        if verify_every and (t + 1) % verify_every == 0:
            carry, max_drift = _resync(elements, carry, max_drift,
                                       [True] * bsz)
        rows.append((res.moved, res.node, res.source, res.dest, res.gain,
                     carry.c0, carry.ct0, active))
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
    """§4.5 simultaneous-sweep mode over a problem stack (DESIGN.md §12),
    element by element through the unbatched
    :func:`~repro_torch.core.refine.refine_simultaneous`, in order.

    Returns ``(RefineResult, (c0s, ct0s, active))`` with leading batch
    axes (the per-sweep potential traces are (B, max_sweeps))."""
    elements, r0, theta = _prepare(problems, assignments, theta)
    return stack_pytrees([
        refine_simultaneous(p, r0[b], framework, max_sweeps=max_sweeps,
                            tol=tol, theta=_row(theta, b))
        for b, p in enumerate(elements)])


def refine_sweeps_batched(problems, assignments,
                          framework: str = costs.C_FRAMEWORK,
                          max_sweeps: int = 256, tol: float = DEFAULT_TOL,
                          theta=None, moves_per_machine: int | None = 1,
                          move_prob: float = 1.0, epsilon: float = 0.0,
                          generators: Sequence[torch.Generator] | None = None):
    """:func:`repro_torch.core.refine.refine_sweeps` over a problem stack
    (DESIGN.md §17): multi-move probabilistic sweep fleets, run element by
    element, in order, each element through the unbatched
    ``refine_sweeps`` (its reads and its early exit are its own).

    ``generators`` is a (B,) sequence of ``torch.Generator`` on the
    problems' device, one per element, required exactly when
    ``move_prob < 1``; element b draws its coins from ``generators[b]``
    alone, so its coin sequence is that of its looped run.  The sweep
    configuration is shared across the batch, like ``framework``.
    Returns ``(RefineResult, (c0s, ct0s, active))`` with leading batch
    axes."""
    elements, r0, theta = _prepare(problems, assignments, theta)
    if move_prob < 1.0:
        if generators is None:
            raise ValueError("refine_sweeps_batched(move_prob < 1) needs a "
                             "(B,) sequence of torch.Generator "
                             "`generators`, one per element")
    if generators is not None and len(generators) != len(elements):
        raise ValueError(f"got {len(generators)} generators for "
                         f"{len(elements)} elements")
    return stack_pytrees([
        refine_sweeps(p, r0[b], framework, max_sweeps=max_sweeps, tol=tol,
                      theta=_row(theta, b),
                      moves_per_machine=moves_per_machine,
                      move_prob=move_prob, epsilon=epsilon,
                      generator=None if generators is None
                      else generators[b])
        for b, p in enumerate(elements)])
