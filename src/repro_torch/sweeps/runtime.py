"""SweepSpec → SweepResult: scenario fleets as stacked batches (DESIGN.md
§12), PyTorch port of ``repro.sweeps.runtime``.

A *sweep* is a flat list of :class:`SweepCase` cells — (problem, initial
assignment, framework, theta) plus a free-form label — executed by
:func:`run_sweep` as a handful of batched runs instead of a Python loop
over cases.  Cases are grouped by (framework, theta present or not,
problem shape key); each group stacks into one batched problem and runs
through the corresponding :mod:`repro_torch.core.batch` entry point.  Per
case, results are the looped results bitwise (moves, assignments, loads,
gains and carried potentials).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..core import costs
from ..core.batch import (problem_shape_key, refine_batched,
                          refine_simultaneous_batched, refine_sweeps_batched,
                          refine_traced_batched, stack_problems,
                          unstack_pytree)
from ..core.problem import PartitionProblem, as_assignment
from ..core.refine import DEFAULT_TOL, RefineResult, Trace
from . import metrics

MODES = ("refine", "traced", "simultaneous", "multimove")


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One scenario cell: a problem instance and how to refine it.

    ``theta`` is the per-node hysteresis threshold (DESIGN.md §11):
    ``None``, a scalar, or an (N,) array.  ``label`` is free-form
    metadata carried through to :meth:`SweepResult.summary`."""
    problem: PartitionProblem
    assignment: Any                   # (N,) int
    framework: str = costs.C_FRAMEWORK
    theta: Any = None
    label: str = ""


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A sweep: cases plus the execution knobs shared by all.

    ``mode`` selects the refinement entry point: ``"refine"`` (to
    convergence), ``"traced"`` (fixed length, per-turn move and potential
    traces), ``"simultaneous"`` (§4.5 sweep mode) or ``"multimove"`` (the
    probabilistic multi-move sweeps of DESIGN.md §17 —
    :func:`repro_torch.core.batch.refine_sweeps_batched`).  Every mode
    runs a group as one loop over its stack; the sweep modes read every
    case's flag once a fleet sweep and stop at the group's longest case.
    ``use_kernel`` keeps the reference's signature but offers no choice:
    ``"refine"`` mode always reduces each turn on kernel 3 (its twin on
    CPU tensors) and so needs ``use_kernel=True``; the other modes, which
    have no ``dissat_fn`` seam, need ``False``.  The port has no
    counterpart of the reference's ``use_kernel=False`` separate-op
    current/best reduction, which cycles on framework c.

    The three multimove knobs — ``moves_per_machine`` (``None`` =
    unbounded), ``move_prob`` and ``epsilon`` — plus ``seed`` (each case's
    acceptance-coin generator is :func:`case_generator` of ``seed`` and
    the case's index, so fleet results are reproducible and independent
    of grouping) apply to ``mode="multimove"`` only; other modes reject
    non-default values."""
    cases: tuple[SweepCase, ...]
    mode: str = "traced"
    max_turns: int = 512
    tol: float = DEFAULT_TOL
    use_kernel: bool = False
    moves_per_machine: int | None = 1
    move_prob: float = 1.0
    epsilon: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown sweep mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.use_kernel and self.mode != "refine":
            raise ValueError("use_kernel applies to mode='refine' only "
                             "(the traced/simultaneous loops have no "
                             "dissat_fn seam)")
        if self.mode != "multimove" and (
                self.moves_per_machine != 1 or self.move_prob != 1.0
                or self.epsilon != 0.0 or self.seed != 0):
            raise ValueError("moves_per_machine/move_prob/epsilon/seed "
                             "apply to mode='multimove' only")
        if self.mode == "refine" and not self.use_kernel:
            raise ValueError("mode='refine' always runs kernel 3 in the "
                             "port; pass use_kernel=True (the reference's "
                             "separate-op reduction is not ported)")


def make_spec(cases: Sequence[SweepCase], **kwargs) -> SweepSpec:
    """Convenience constructor accepting any iterable of cases."""
    return SweepSpec(cases=tuple(cases), **kwargs)


def case_generator(seed: int, index: int, device) -> torch.Generator:
    """The acceptance-coin generator of the case at position ``index`` of
    a multimove sweep's ``cases``, on ``device``.

    Seeded from ``(seed, index)`` alone — numpy's ``SeedSequence`` mix of
    the pair, 64 bits — so a case's coins do not depend on how the fleet
    groups, as the reference's ``fold_in(PRNGKey(seed), index)`` keys do
    not.  A lone ``refine_sweeps`` run given this generator reproduces
    the case bitwise."""
    mixed = np.random.SeedSequence([seed % 2 ** 64, index]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed))
    return gen


def _group_key(case: SweepCase):
    """Cases sharing this key stack into one batched run:
    (framework, theta absent, problem shape key) — the shape key being
    (representation, N, K) plus, for sparse problems, (padded E,
    max_degree)."""
    return (case.framework, case.theta is None,
            problem_shape_key(case.problem))


def _stack_group(cases: list[SweepCase]):
    problems = stack_problems([c.problem for c in cases])
    n = cases[0].problem.num_nodes
    dev = problems.device
    r0 = torch.stack([as_assignment(c.assignment, dev).expand(n)
                      for c in cases])
    if cases[0].theta is None:
        theta = None
    else:
        theta = torch.stack([_f32(c.theta, dev).expand(n) for c in cases])
    return problems, r0, theta


def _f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def run_sweep(spec: SweepSpec, recorder=None) -> "SweepResult":
    """Execute a sweep: one batched run per case group.

    Groups are keyed on (framework, theta present, problem shape key);
    everything else — adjacency or edge list, weights, speeds, mu, theta
    values, initial assignments — varies freely inside a group.  Returns
    a :class:`SweepResult` with per-case results and traces in the order
    of ``spec.cases``.

    ``recorder`` (a :class:`repro_torch.obs.Recorder`, DESIGN.md §14)
    opts into telemetry: each group's run is a timed ``phase`` span
    (ending in a device sync, so it covers the card's work), every case
    closes with one ``element`` event (its headline summary stats),
    traced-mode cases additionally stream their per-turn events tagged
    with the case index, and the run ends with fleet totals.
    ``recorder=None`` runs the identical batched runs.
    """
    ncases = len(spec.cases)
    groups: dict[tuple, list[int]] = {}
    for i, case in enumerate(spec.cases):
        groups.setdefault(_group_key(case), []).append(i)

    run = None
    if recorder is not None:
        run = recorder.new_run("sweep", mode=spec.mode, cases=ncases,
                               groups=len(groups),
                               use_kernel=spec.use_kernel)

    results: list = [None] * ncases
    traces: list = [None] * ncases
    for key, idxs in groups.items():
        cases = [spec.cases[i] for i in idxs]
        problems, r0, theta = _stack_group(cases)
        framework = key[0]
        if recorder is None:
            out, tr = _run_group(spec, idxs, problems, r0, theta, framework)
        else:
            n, k = cases[0].problem.num_nodes, cases[0].problem.num_machines
            label = f"sweep.{spec.mode}[{framework} n={n} k={k} B={len(idxs)}]"
            with recorder.phase(label, run):
                out, tr = _run_group(spec, idxs, problems, r0, theta,
                                     framework)
                if problems.device.type == "cuda":
                    torch.cuda.synchronize()
        for j, i in enumerate(idxs):
            results[i] = unstack_pytree(out, j)
            traces[i] = None if tr is None else unstack_pytree(tr, j)
    result = SweepResult(spec=spec, results=results, traces=traces)
    if recorder is not None:
        if spec.mode == "traced":
            for i, (case, tr) in enumerate(zip(spec.cases, traces)):
                recorder.record_trace(run, tr, case.problem.node_weights,
                                      case.problem.num_machines, batch=i)
        for i, row in enumerate(result.summary()):
            recorder.emit("element", run, batch=i, **row)
        recorder.emit("run_end", run,
                      num_moves=int(result.moves.sum()),
                      num_turns=int(result.turns.max()) if ncases else 0,
                      converged=bool(result.converged.all()))
    return result


def _run_group(spec: SweepSpec, idxs: list[int], problems, r0, theta,
               framework: str):
    """One group's batched run: ``(result, per-case outputs or None)``."""
    if spec.mode == "refine":
        return refine_batched(problems, r0, framework,
                              max_turns=spec.max_turns, tol=spec.tol,
                              theta=theta), None
    if spec.mode == "traced":
        return refine_traced_batched(problems, r0, framework,
                                     max_turns=spec.max_turns, tol=spec.tol,
                                     theta=theta)
    if spec.mode == "multimove":
        gens = None
        if spec.move_prob < 1.0:
            gens = [case_generator(spec.seed, i, problems.device)
                    for i in idxs]
        return refine_sweeps_batched(
            problems, r0, framework, max_sweeps=spec.max_turns,
            tol=spec.tol, theta=theta,
            moves_per_machine=spec.moves_per_machine,
            move_prob=spec.move_prob, epsilon=spec.epsilon, generators=gens)
    return refine_simultaneous_batched(problems, r0, framework,
                                       max_sweeps=spec.max_turns,
                                       tol=spec.tol, theta=theta)


def _np(x) -> np.ndarray:
    """A host copy of a tensor (or an array-like) for the numpy reductions."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class SweepResult:
    """Per-case outcomes of a sweep, ordered like ``spec.cases``.

    ``results[i]`` is case i's :class:`~repro_torch.core.refine.
    RefineResult`; ``traces[i]`` is its ``Trace`` (traced mode), its
    ``(c0s, ct0s, active)`` per-sweep potentials (simultaneous and
    multimove modes) or ``None`` (refine mode).  The methods below reduce
    across the fleet on the host (DESIGN.md §12.5)."""
    spec: SweepSpec
    results: list[RefineResult]
    traces: list

    def __len__(self) -> int:
        return len(self.results)

    @property
    def moves(self) -> np.ndarray:
        return np.asarray([int(r.num_moves) for r in self.results])

    @property
    def turns(self) -> np.ndarray:
        return np.asarray([int(r.num_turns) for r in self.results])

    @property
    def converged(self) -> np.ndarray:
        return np.asarray([bool(r.converged) for r in self.results])

    @property
    def assignments(self) -> np.ndarray:
        """(B, N) final assignments (cases must share N to stack)."""
        return np.stack([_np(r.assignment) for r in self.results])

    def load_cv(self) -> np.ndarray:
        """(B,) final cross-machine CV of L_k/w_k per case."""
        return np.asarray([
            float(metrics.load_cv(_np(r.loads), _np(c.problem.speeds)))
            for r, c in zip(self.results, self.spec.cases)])

    def load_cv_traces(self) -> list[np.ndarray]:
        """Per-case (T,) CV-descent traces (traced mode only)."""
        if self.spec.mode != "traced":
            raise ValueError("CV traces need mode='traced'")
        return [
            metrics.load_cv_trace(_np(c.problem.node_weights),
                                  _np(c.problem.speeds), _np(c.assignment),
                                  Trace(*(_np(x) for x in tr)))
            for c, tr in zip(self.spec.cases, self.traces)]

    def final_potentials(self) -> tuple[np.ndarray, np.ndarray]:
        """(B,) final (C_0, Ct_0) per case.

        Traced, simultaneous and multimove modes read the carried
        per-turn potentials' last entry; refine mode evaluates them from
        the final assignments."""
        if self.spec.mode == "traced":
            return (np.asarray([float(t.c0[-1]) for t in self.traces]),
                    np.asarray([float(t.ct0[-1]) for t in self.traces]))
        if self.spec.mode in ("simultaneous", "multimove"):
            return (np.asarray([float(t[0][-1]) for t in self.traces]),
                    np.asarray([float(t[1][-1]) for t in self.traces]))
        c0 = [float(costs.global_cost_c0(c.problem, r.assignment))
              for c, r in zip(self.spec.cases, self.results)]
        ct0 = [float(costs.global_cost_ct0(c.problem, r.assignment))
               for c, r in zip(self.spec.cases, self.results)]
        return np.asarray(c0), np.asarray(ct0)

    def summary(self) -> list[dict]:
        """One dict per case: label/framework plus the headline stats."""
        cv = self.load_cv()
        c0, ct0 = self.final_potentials()
        return [{
            "label": c.label,
            "framework": c.framework,
            "moves": int(m),
            "converged": bool(cvg),
            "load_cv": float(v),
            "c0": float(a),
            "ct0": float(b),
        } for c, m, cvg, v, a, b in zip(
            self.spec.cases, self.moves, self.converged, cv, c0, ct0)]
