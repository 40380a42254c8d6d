"""The port's refinement game against the JAX reference, on the CPU.

The port's problem is carried over bit for bit with
``problem_from_arrays``; both sides start from the same numpy-made
assignment.  Integer outcomes (move counts, turn counts, assignments,
traced move sequences) must match exactly; potentials are held to 1e-3
relative (the reference's budget, DESIGN.md §10).

The reference's jnp refine path cycles on framework c (ROADMAP queue 3,
caveat 1), so framework c is held against the reference's kernel path
(``dissat_fn=make_aggregate_dissat_fn(interpret=True)``) and the jnp path
is compared on framework ct only.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import costs as jcosts
from repro.core.refine import refine as j_refine
from repro.core.refine import refine_simultaneous as j_refine_simultaneous
from repro.core.refine import refine_traced as j_refine_traced
from repro.kernels import ops as jops
from repro_torch.core import aggregate as agg_mod
from repro_torch.core import costs
from repro_torch.core.problem import make_state, problem_from_arrays
from repro_torch.core.refine import (DEFAULT_TOL, refine,
                                     refine_simultaneous, refine_traced)
from repro_torch.kernels import ops

torch.set_num_threads(1)

REL = 1e-3


@pytest.fixture(scope="module")
def pair(paper_problem):
    """(reference problem, port problem, r0) on identical bits."""
    _, prob = paper_problem
    port = problem_from_arrays(np.asarray(prob.adjacency),
                               np.asarray(prob.node_weights),
                               np.asarray(prob.speeds), np.asarray(prob.mu),
                               device="cpu")
    r0 = np.random.default_rng(42).integers(0, 5, 230).astype(np.int32)
    return prob, port, r0


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("theta", [None, 0.5])
@pytest.mark.parametrize("framework,moves,turns",
                         [("c", 95, 121), ("ct", 53, 73)])
def test_refine_matches_reference_kernel_path(pair, framework, moves, turns,
                                              theta):
    """The port's default refine (the fused reduction's twin) reproduces
    the reference's kernel path: same move and turn counts, converged,
    same final assignment."""
    prob, port, r0 = pair
    want = j_refine(prob, jnp.asarray(r0), framework, theta=theta,
                          dissat_fn=jops.make_aggregate_dissat_fn(
                              interpret=True))
    got = refine(port, r0, framework, theta=theta)
    if theta is None:
        assert (int(want.num_moves), int(want.num_turns)) == (moves, turns)
    assert int(got.num_moves) == int(want.num_moves)
    assert int(got.num_turns) == int(want.num_turns)
    assert bool(got.converged) and bool(want.converged)
    _eq(got.assignment.numpy(), want.assignment)
    np.testing.assert_allclose(got.loads.numpy(), np.asarray(want.loads),
                               rtol=1e-5)


@pytest.mark.parametrize("kernel_fn", [False, True])
def test_recompute_path_matches_reference_ct(pair, kernel_fn):
    """The recompute path (jnp costs, or the cost-matrix kernel's twin via
    ``cost_matrix_fn``) vs the reference's recompute path on ct."""
    prob, port, r0 = pair
    want = j_refine(prob, jnp.asarray(r0), "ct", incremental=False)
    fn = ops.make_core_cost_matrix_fn() if kernel_fn else None
    got = refine(port, r0, "ct", incremental=False, cost_matrix_fn=fn)
    assert int(got.num_moves) == int(want.num_moves)
    assert int(got.num_turns) == int(want.num_turns)
    assert bool(got.converged)
    _eq(got.assignment.numpy(), want.assignment)


@pytest.mark.parametrize("incremental", [True, False])
def test_refine_traced_matches_reference_ct(pair, incremental):
    """Traced moves equal the reference's exactly; potentials <= 1e-3."""
    prob, port, r0 = pair
    want_res, want = j_refine_traced(prob, jnp.asarray(r0), "ct",
                                           max_turns=128,
                                           incremental=incremental)
    got_res, got = refine_traced(port, r0, "ct", max_turns=128,
                                 incremental=incremental)
    for field in ("moved", "node", "source", "dest", "active"):
        _eq(getattr(got, field).numpy(), getattr(want, field))
    np.testing.assert_allclose(got.gain.numpy(), np.asarray(want.gain),
                               rtol=REL, atol=1e-2)
    np.testing.assert_allclose(got.c0.numpy(), np.asarray(want.c0), rtol=REL)
    np.testing.assert_allclose(got.ct0.numpy(), np.asarray(want.ct0),
                               rtol=REL)
    assert int(got_res.num_moves) == int(want_res.num_moves)
    assert int(got_res.num_turns) == int(want_res.num_turns)
    _eq(got_res.assignment.numpy(), want_res.assignment)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_incremental_equals_recompute_within_port(pair, framework):
    """Within the port: the incremental path, the recompute path and the
    recompute path on the cost-matrix twin land on the same equilibrium
    with the same counts."""
    _, port, r0 = pair
    inc = refine(port, r0, framework)
    rec = refine(port, r0, framework, incremental=False)
    ker = refine(port, r0, framework,
                 cost_matrix_fn=ops.make_core_cost_matrix_fn())
    for other in (rec, ker):
        assert int(other.num_moves) == int(inc.num_moves)
        assert int(other.num_turns) == int(inc.num_turns)
        assert bool(other.converged)
        _eq(other.assignment.numpy(), inc.assignment.numpy())


def test_refine_simultaneous_matches_reference_ct(pair):
    """§4.5 mode on ct: same sweeps, moves and final assignment; per-sweep
    closed-form potentials within 1e-3."""
    prob, port, r0 = pair
    want, (wc0, wct0, wact) = j_refine_simultaneous(
        prob, jnp.asarray(r0), "ct", max_sweeps=64)
    got, (gc0, gct0, gact) = refine_simultaneous(port, r0, "ct",
                                                 max_sweeps=64)
    assert int(got.num_moves) == int(want.num_moves)
    assert int(got.num_turns) == int(want.num_turns)
    assert bool(got.converged) == bool(want.converged)
    _eq(got.assignment.numpy(), want.assignment)
    _eq(gact.numpy(), wact)
    np.testing.assert_allclose(gc0.numpy(), np.asarray(wc0), rtol=REL)
    np.testing.assert_allclose(gct0.numpy(), np.asarray(wct0), rtol=REL)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_verify_every_bounds_drift(pair, framework):
    """``verify_every`` observes only f32 drift (<= 1e-3 of the potentials'
    scale) and leaves the equilibrium unchanged."""
    _, port, r0 = pair
    plain = refine(port, r0, framework)
    checked = refine(port, r0, framework, verify_every=16)
    scale = max(abs(float(costs.global_cost_c0(port, plain.assignment))),
                abs(float(costs.global_cost_ct0(port, plain.assignment))))
    assert float(checked.aggregate_drift) > 0.0
    assert float(checked.aggregate_drift) <= REL * scale
    _eq(checked.assignment.numpy(), plain.assignment.numpy())
    assert int(checked.num_turns) == int(plain.num_turns)


def test_repair_every_rolls_back_injected_nan(pair):
    """A NaN written into the carried aggregate mid-run is rolled back at
    the next ``repair_every`` boundary (drift reads inf), and the run
    still ends at an equilibrium."""
    _, port, r0 = pair
    calls = {"n": 0}
    inner = ops.make_aggregate_dissat_fn()

    def poisoning(aggregate, *args):
        calls["n"] += 1
        if calls["n"] == 21:          # turn 20: after the turn-16 checkpoint
            aggregate[3, 1] = float("nan")
        return inner(aggregate, *args)

    res = refine(port, r0, "ct", repair_every=16, dissat_fn=poisoning)
    assert calls["n"] > 21
    assert float(res.aggregate_drift) == float("inf")
    assert bool(res.converged)
    dis, _ = costs.dissatisfaction(port, make_state(port, res.assignment),
                                   "ct")
    assert float(dis.max()) <= DEFAULT_TOL


def test_repair_every_clean_run_is_unchanged(pair):
    """On an undrifted carry the repair boundaries change nothing."""
    _, port, r0 = pair
    plain = refine(port, r0, "c")
    healed = refine(port, r0, "c", repair_every=16)
    _eq(healed.assignment.numpy(), plain.assignment.numpy())
    assert int(healed.num_moves) == int(plain.num_moves)
    assert float(healed.aggregate_drift) < 1.0


def test_potentials_match_reference(pair):
    """C_0, Ct_0, the closed forms and the load imbalance within 1e-3 of
    the reference; the carried potentials of a run within 1e-3 of a
    from-scratch evaluation."""
    prob, port, r0 = pair
    rt = torch.from_numpy(r0)
    for fn, jfn in ((costs.global_cost_c0, jcosts.global_cost_c0),
                    (costs.global_cost_ct0, jcosts.global_cost_ct0),
                    (costs.load_imbalance, jcosts.load_imbalance)):
        np.testing.assert_allclose(float(fn(port, rt)),
                                   float(jfn(prob, jnp.asarray(r0))),
                                   rtol=REL)
    agg = agg_mod.rebuild_state(port, rt, torch.sum(port.node_weights))
    np.testing.assert_allclose(float(agg.c0),
                               float(jcosts.global_cost_c0(prob,
                                                           jnp.asarray(r0))),
                               rtol=REL)
    np.testing.assert_allclose(float(agg.ct0),
                               float(jcosts.global_cost_ct0(
                                   prob, jnp.asarray(r0))), rtol=REL)
    res, trace = refine_traced(port, r0, "c", max_turns=160)
    last = int(res.num_turns) - 1
    np.testing.assert_allclose(float(trace.c0[last]),
                               float(costs.global_cost_c0(port,
                                                          res.assignment)),
                               rtol=REL)
    np.testing.assert_allclose(float(trace.ct0[last]),
                               float(costs.global_cost_ct0(port,
                                                           res.assignment)),
                               rtol=REL)


def test_refine_rejects_what_is_not_ported(pair):
    """``refine`` takes a recorder (run telemetry) and returns the
    recorder-free result, one ``turn`` event a turn; an object that is
    neither kind of problem is refused with a TypeError."""
    from repro_torch.obs import Recorder
    _, port, r0 = pair
    rec = Recorder()
    res = refine(port, r0, "c", recorder=rec)
    base = refine(port, r0, "c")
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(res, base))
    kinds = [e["kind"] for e in rec.events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("turn") == int(res.num_turns)
    with pytest.raises(TypeError, match="PartitionProblem or a SparseProblem"):
        refine(object(), r0, "c")
