"""The port's ``SweepSpec → run_sweep → SweepResult`` runtime
(``repro_torch.sweeps``, DESIGN.md §12) on the CPU, against its own looped
runs and against the reference's runtime on the same numpy-made cases.

Per case, a sweep's result is its looped run bitwise.  The reference's
``run_sweep(mode="refine", use_kernel=True)`` is matched exactly in
assignments and moves; multimove coins come from ``torch.Generator``\\ s
(the reference's threefry bits cannot be reproduced), so multimove cases
are held to a lone ``refine_sweeps`` run with the generator derived for
their index, whatever the grouping.  ``SweepSpec`` raises the reference's
errors, and the numpy metrics are the reference's numbers.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import sweeps as jsweeps
from repro_torch import sweeps
from repro_torch.core.refine import refine_sweeps, refine_traced
from repro_torch.core.sparse import sparse_from_dense
from repro_torch.sweeps.runtime import case_generator

from test_torch_batch import _dense_fleet

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _cases(num=6, seed0=50, port=True):
    """Mixed frameworks and thetas (None, scalar), as the reference's own
    runtime tests mix them; ``port=False`` gives the reference's cases on
    the same bits."""
    jps, ports, r0s = _dense_fleet(num, seed0=seed0)
    mod = sweeps if port else jsweeps
    return [mod.SweepCase(
        problem=(ports if port else jps)[i],
        assignment=r0s[i] if port else jnp.asarray(r0s[i]),
        framework="c" if i % 2 == 0 else "ct",
        theta=None if i % 3 == 0 else float(i),
        label=f"case{i}") for i in range(num)]


def test_run_sweep_groups_and_preserves_case_order():
    cases = _cases()
    keys = {sweeps.runtime._group_key(c) for c in cases}
    assert len(keys) == 4            # framework x theta present
    res = sweeps.run_sweep(sweeps.make_spec(cases, mode="traced",
                                            max_turns=64))
    assert len(res) == len(cases)
    for i, case in enumerate(cases):
        res_l, tr_l = refine_traced(case.problem, case.assignment,
                                    case.framework, max_turns=64,
                                    theta=case.theta)
        for a, b in zip(res_l + tr_l, res.results[i] + res.traces[i]):
            assert torch.equal(a, b), case.label
    assert [s["label"] for s in res.summary()] == [c.label for c in cases]


@pytest.mark.parametrize("mode", ["refine", "traced", "simultaneous",
                                  "multimove"])
def test_run_sweep_every_mode_runs(mode):
    cases = _cases(4, seed0=60)
    kw = {"multimove": dict(moves_per_machine=2, move_prob=0.5,
                            epsilon=1e-3, seed=3),
          "refine": dict(use_kernel=True)}.get(mode, {})
    res = sweeps.run_sweep(sweeps.make_spec(cases, mode=mode, max_turns=128,
                                            **kw))
    c0, ct0 = res.final_potentials()
    assert c0.shape == ct0.shape == (4,)
    assert np.isfinite(c0).all() and np.isfinite(ct0).all()
    assert res.assignments.shape == (4, 40)
    assert (res.moves > 0).all() and (res.turns > 0).all()
    cv = res.load_cv()
    assert cv.shape == (4,) and (cv >= 0).all()
    if mode == "refine":
        assert res.converged.all()


def test_run_sweep_sparse_groups_by_padded_shape():
    """Sparse cases stack by (N, K, padded E, max_degree): two fleets of
    different padding run as two groups, each case equal to its looped
    run."""
    _, ports, r0s = _dense_fleet(4, n=48, seed0=70)
    sps = [sparse_from_dense(p, pad_edges_multiple=512 * (1 + i // 2),
                             pad_degree_multiple=32)
           for i, p in enumerate(ports)]
    cases = [sweeps.SweepCase(problem=sp, assignment=r, framework="ct")
             for sp, r in zip(sps, r0s)]
    assert len({sweeps.runtime._group_key(c) for c in cases}) == 2
    res = sweeps.run_sweep(sweeps.make_spec(cases, mode="traced",
                                            max_turns=48))
    for i, case in enumerate(cases):
        _, tr_l = refine_traced(case.problem, case.assignment, "ct",
                                max_turns=48)
        for a, b in zip(tr_l, res.traces[i]):
            assert torch.equal(a, b)


def test_run_sweep_refine_matches_reference_kernel_runtime():
    """``mode="refine"`` (kernel 3, its twin here) equals the reference's
    kernel-path runtime exactly."""
    want = jsweeps.run_sweep(jsweeps.make_spec(
        _cases(port=False), mode="refine", max_turns=2000, use_kernel=True))
    got = sweeps.run_sweep(sweeps.make_spec(_cases(), mode="refine",
                                            max_turns=2000, use_kernel=True))
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_array_equal(got.moves, want.moves)
    np.testing.assert_array_equal(got.turns, want.turns)
    assert got.converged.all() and want.converged.all()


def test_sweep_spec_refine_requires_the_kernel():
    """The port offers no reduction but kernel 3 in ``"refine"`` mode, so
    a spec asking for the reference's separate-op path is refused rather
    than silently run on the kernel."""
    with pytest.raises(ValueError, match="use_kernel=True"):
        sweeps.make_spec(_cases(2), mode="refine")


def test_multimove_results_do_not_depend_on_grouping():
    """Case i draws from ``case_generator(seed, i)`` whatever else the
    sweep holds: the same cases under another grouping (other cases'
    frameworks changed) give the same per-case results, each equal to a
    lone ``refine_sweeps`` run with that generator."""
    cfg = dict(moves_per_machine=None, move_prob=0.5, epsilon=1e-3)
    cases = _cases(4, seed0=80)
    regrouped = [c if i % 2 == 0 else sweeps.SweepCase(
        problem=c.problem, assignment=c.assignment, framework="c",
        theta=c.theta, label=c.label) for i, c in enumerate(cases)]
    runs = [sweeps.run_sweep(sweeps.make_spec(cs, mode="multimove",
                                              max_turns=64, seed=11, **cfg))
            for cs in (cases, regrouped)]
    assert len({sweeps.runtime._group_key(c) for c in cases}) != len(
        {sweeps.runtime._group_key(c) for c in regrouped})
    for i in (0, 2):
        for a, b in zip(runs[0].results[i] + runs[0].traces[i],
                        runs[1].results[i] + runs[1].traces[i]):
            assert torch.equal(a, b)
    for i, case in enumerate(cases):
        res_l, tr_l = refine_sweeps(
            case.problem, case.assignment, case.framework, max_sweeps=64,
            theta=case.theta, generator=case_generator(11, i, "cpu"), **cfg)
        for a, b in zip(res_l + tr_l, runs[0].results[i] + runs[0].traces[i]):
            assert torch.equal(a, b), case.label


@pytest.mark.parametrize("kwargs", [
    dict(mode="bogus"), dict(mode="traced", use_kernel=True),
    dict(mode="traced", move_prob=0.5),
    dict(mode="simultaneous", moves_per_machine=None),
    dict(mode="refine", seed=3), dict(mode="refine", epsilon=0.1)])
def test_sweep_spec_validation_matches_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jsweeps.make_spec(_cases(2, port=False), **kwargs)
    with pytest.raises(ValueError) as got:
        sweeps.make_spec(_cases(2), **kwargs)
    assert str(got.value) == str(want.value)


def test_run_sweep_rejects_recorder():
    """``run_sweep`` takes a recorder (run telemetry): one timed phase a
    group, one ``element`` event a case, the recorder-free results."""
    from repro_torch.obs import Recorder
    spec = sweeps.make_spec(_cases(2), mode="refine", use_kernel=True)
    rec = Recorder()
    out = sweeps.run_sweep(spec, recorder=rec)
    base = sweeps.run_sweep(spec)
    assert (out.assignments == base.assignments).all()
    assert (out.moves == base.moves).all()
    kinds = [e["kind"] for e in rec.events]
    assert kinds.count("phase") == 2 and kinds.count("element") == 2
    assert kinds[-1] == "run_end"


def test_metrics_are_the_references():
    """The port's numpy metrics give the reference's numbers, and the
    sweep's CV traces replay to its final loads."""
    rng = np.random.default_rng(5)
    loads = rng.uniform(1, 9, (3, 5))
    speeds = rng.uniform(0.5, 2, 5)
    np.testing.assert_array_equal(sweeps.load_cv(loads, speeds),
                                  jsweeps.load_cv(loads, speeds))
    trace = rng.uniform(0, 4, (40, 5))
    trace[:3] = 0.0
    assert sweeps.time_averaged_cv(trace) == jsweeps.time_averaged_cv(trace)
    cases = _cases(3, seed0=90)
    res = sweeps.run_sweep(sweeps.make_spec(cases, mode="traced",
                                            max_turns=96))
    cv = res.load_cv()
    for i, (case, tr) in enumerate(zip(cases, res.load_cv_traces())):
        want = jsweeps.load_cv_trace(case.problem.node_weights.numpy(),
                                     case.problem.speeds.numpy(),
                                     case.assignment,
                                     type(res.traces[i])(
                                         *(x.numpy() for x in res.traces[i])))
        np.testing.assert_array_equal(tr, want)
        assert tr.shape == (96,)
        np.testing.assert_allclose(tr[-1], cv[i], rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="traced"):
        sweeps.run_sweep(sweeps.make_spec(cases, mode="refine", max_turns=8,
                                          use_kernel=True)).load_cv_traces()


def test_sweep_study_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.sweep_study",
                          "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "18 cells -> 4 batched runs" in out.stdout
    assert sum(line.startswith(("random-degree/", "pref-attach/",
                                "geometric/"))
               for line in out.stdout.splitlines()) == 18
