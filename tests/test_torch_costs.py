"""The port's problem, cost and aggregate modules against the reference.

Inputs come from numpy seeds and reach both packages as arrays.  Where
both sides run the same elementwise ops on the same bits the results must
be bitwise equal; where a product or a long sum is involved (the
aggregate, the potentials) they are held to 1e-5 relative, a few ULP of
f32 summed in another order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import aggregate as jagg
from repro.core import checkpoint as jckpt
from repro.core import costs as jcosts
from repro.core.problem import make_problem as j_make_problem
from repro_torch.core import aggregate as agg_mod
from repro_torch.core import checkpoint as ckpt_mod
from repro_torch.core import costs
from repro_torch.core.problem import (ProblemValidationError, machine_loads,
                                      make_problem, make_state,
                                      problem_from_arrays,
                                      validate_assignment)
from repro_torch.graphs.generators import random_degree_graph, random_weights

torch.set_num_threads(1)

RTOL = 1e-5


def _raw(n=48, k=4, seed=0):
    adj = random_degree_graph(n, seed=seed, dmin=2, dmax=4)
    b, c = random_weights(adj, seed=seed + 1, mean=5.0)
    speeds = np.random.default_rng(seed + 2).uniform(0.5, 2.0, k)
    r = np.random.default_rng(seed + 3).integers(0, k, n).astype(np.int32)
    return c, b, speeds, r


def _pair(n=48, k=4, seed=0, mu=4.0):
    c, b, speeds, r = _raw(n, k, seed)
    ref = j_make_problem(c, b, speeds, mu=mu)
    port = problem_from_arrays(np.asarray(ref.adjacency),
                               np.asarray(ref.node_weights),
                               np.asarray(ref.speeds), np.asarray(ref.mu),
                               device="cpu")
    return ref, port, r


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_make_problem_equals_reference():
    """Symmetrization, zeroed diagonal and speed normalization."""
    c, b, speeds, _ = _raw(40, 5, seed=4)
    c = c + np.triu(np.ones_like(c), 1) * 0.25      # asymmetric input
    np.fill_diagonal(c, 3.0)
    ref = j_make_problem(c, b, speeds, mu=8.0)
    port = make_problem(c, b, speeds, mu=8.0, device="cpu")
    _eq(port.adjacency.numpy(), ref.adjacency)
    _eq(port.node_weights.numpy(), ref.node_weights)
    np.testing.assert_allclose(port.speeds.numpy(), np.asarray(ref.speeds),
                               rtol=1e-6)
    assert float(port.mu) == float(ref.mu)
    assert port.num_nodes == 40 and port.num_machines == 5


@pytest.mark.parametrize("field,value,match", [
    ("adjacency", np.nan, "NaN"),
    ("adjacency", -1.0, "negative"),
    ("node_weights", np.nan, "node_weights"),
    ("speeds", 0.0, "speeds"),
])
def test_validation_errors(field, value, match):
    ref, port, _ = _pair(20, 3, seed=1)
    arrays = {name: np.array(getattr(ref, name))
              for name in ("adjacency", "node_weights", "speeds")}
    if field == "adjacency":
        arrays[field][0, 1] = arrays[field][1, 0] = value
    else:
        arrays[field][0] = value
    with pytest.raises(ProblemValidationError, match=match):
        problem_from_arrays(arrays["adjacency"], arrays["node_weights"],
                            arrays["speeds"], 4.0, device="cpu")


def test_asymmetric_adjacency_rejected():
    ref, _, _ = _pair(20, 3, seed=2)
    adj = np.array(ref.adjacency)
    adj[0, 1] += 1.0
    with pytest.raises(ProblemValidationError, match="symmetric"):
        problem_from_arrays(adj, ref.node_weights, ref.speeds, 4.0,
                            device="cpu")


def test_validate_assignment():
    validate_assignment(torch.tensor([0, 2, 1], dtype=torch.int32), 3, 3)
    with pytest.raises(ProblemValidationError, match="range"):
        validate_assignment(torch.tensor([0, 3]), 3)
    with pytest.raises(ProblemValidationError, match="integer"):
        validate_assignment(torch.tensor([0.0, 1.0]), 3)
    with pytest.raises(ProblemValidationError, match="entries"):
        validate_assignment(torch.tensor([0, 1]), 3, num_nodes=3)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_cost_matrix_and_dissatisfaction(framework):
    ref, port, r = _pair(seed=5)
    jstate = jcosts.PartitionState(jnp.asarray(r), jcosts.machine_loads(
        ref.node_weights, jnp.asarray(r), 4))
    state = make_state(port, r)
    np.testing.assert_allclose(state.loads.numpy(), np.asarray(jstate.loads),
                               rtol=RTOL)
    want = np.array(jcosts.cost_matrix(ref, jstate, framework))
    got = costs.cost_matrix(port, state, framework).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)
    # on one cost block the Eq.-4 reduction is exact
    cost = torch.from_numpy(want)
    d, best = costs.dissatisfaction_from_cost(cost, torch.from_numpy(r))
    jd, jbest = jcosts.dissatisfaction_from_cost(jnp.asarray(want),
                                                 jnp.asarray(r))
    _eq(best.numpy(), jbest)
    _eq(d.numpy(), jd)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_cost_matrix_from_aggregate_same_aggregate(framework):
    """Fed the same aggregate and loads, the shared cost assembly agrees
    with the reference's to an ULP or two."""
    ref, port, r = _pair(seed=6)
    agg = np.array(jcosts.adjacency_aggregate(ref.adjacency,
                                              jnp.asarray(r), 4))
    loads = np.array(jcosts.machine_loads(ref.node_weights,
                                          jnp.asarray(r), 4))
    want = np.asarray(jcosts.cost_matrix_from_aggregate(
        jnp.asarray(agg), jnp.asarray(r), ref.node_weights,
        jnp.asarray(loads), ref.speeds, ref.mu, framework))
    got = costs.cost_matrix_from_aggregate(
        torch.from_numpy(agg), torch.from_numpy(r), port.node_weights,
        torch.from_numpy(loads), port.speeds, port.mu, framework).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


def test_potentials_cut_and_identities():
    ref, port, r = _pair(seed=7)
    rt, rj = torch.from_numpy(r), jnp.asarray(r)
    np.testing.assert_allclose(float(costs.total_cut(port.adjacency, rt)),
                               float(jcosts.total_cut(ref.adjacency, rj)),
                               rtol=RTOL)
    cut_m = costs.cut_matrix(port.adjacency, rt, 4).numpy()
    np.testing.assert_allclose(
        cut_m, np.asarray(jcosts.cut_matrix(ref.adjacency, rj, 4)),
        rtol=RTOL, atol=1e-4)
    agg = costs.adjacency_aggregate(port.adjacency, rt, 4)
    np.testing.assert_allclose(float(agg_mod.cut_from_aggregate(agg, rt)),
                               float(costs.total_cut(port.adjacency, rt)),
                               rtol=RTOL)
    b = port.node_weights
    c0, ct0 = costs.potentials_closed_form(
        machine_loads(b, rt, 4), machine_loads(b * b, rt, 4),
        costs.total_cut(port.adjacency, rt), port.speeds, port.mu,
        torch.sum(b))
    np.testing.assert_allclose(float(c0), float(costs.global_cost_c0(port,
                                                                     rt)),
                               rtol=1e-4)
    np.testing.assert_allclose(float(ct0),
                               float(costs.global_cost_ct0(port, rt)),
                               rtol=1e-4)
    for fw, jfn in (("c", jcosts.global_cost_c0),
                    ("ct", jcosts.global_cost_ct0)):
        np.testing.assert_allclose(float(costs.global_cost(port, rt, fw)),
                                   float(jfn(ref, rj)), rtol=RTOL)


def test_apply_move_matches_reference():
    """One accepted and one rejected move: the aggregate and loads are
    bitwise the reference's, the potential deltas within 1e-5."""
    ref, port, r = _pair(seed=8)
    jstate = jagg.init_aggregate_state(ref, jnp.asarray(r))
    state = agg_mod.AggregateState(
        assignment=torch.from_numpy(r), loads=torch.from_numpy(
            np.array(jstate.loads)),
        aggregate=torch.from_numpy(np.array(jstate.aggregate)),
        c0=torch.tensor(float(jstate.c0)), ct0=torch.tensor(float(jstate.ct0)))
    total_b = float(np.sum(np.asarray(ref.node_weights)))
    node, source = 5, int(r[5])
    dest = (source + 1) % 4
    for do_move in (True, False):
        want = jagg.apply_move(ref, jstate, jnp.int32(node),
                               jnp.int32(source), jnp.int32(dest),
                               jnp.asarray(do_move), jnp.float32(total_b))
        got = agg_mod.apply_move(port, state, node, source, dest, do_move,
                                 torch.tensor(total_b))
        _eq(got.aggregate.numpy(), want.aggregate)
        _eq(got.loads.numpy(), want.loads)
        _eq(got.assignment.numpy(), want.assignment)
        np.testing.assert_allclose(float(got.c0), float(want.c0), rtol=RTOL)
        np.testing.assert_allclose(float(got.ct0), float(want.ct0),
                                   rtol=RTOL)


def test_apply_sweep_matches_reference():
    """A §4.5 sweep with a duplicated destination and an idle machine."""
    ref, port, r = _pair(seed=9)
    jstate = jagg.init_aggregate_state(ref, jnp.asarray(r))
    state = agg_mod.AggregateState(
        torch.from_numpy(r), torch.from_numpy(np.array(jstate.loads)),
        torch.from_numpy(np.array(jstate.aggregate)),
        torch.tensor(float(jstate.c0)), torch.tensor(float(jstate.ct0)))
    picks = np.array([int(np.flatnonzero(r == m)[0]) for m in range(4)],
                     np.int32)
    dests = np.array([2, 2, 0, 1], np.int32)
    will = np.array([True, True, False, True])
    total_b = float(np.sum(np.asarray(ref.node_weights)))
    want = jagg.apply_sweep(ref, jstate, jnp.asarray(picks),
                            jnp.asarray(dests), jnp.asarray(will),
                            jnp.float32(total_b))
    got = agg_mod.apply_sweep(port, state, torch.from_numpy(picks),
                              torch.from_numpy(dests), torch.from_numpy(will),
                              torch.tensor(total_b))
    _eq(got.assignment.numpy(), want.assignment)
    np.testing.assert_allclose(got.aggregate.numpy(),
                               np.asarray(want.aggregate), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(got.loads.numpy(), np.asarray(want.loads),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.c0), float(want.c0), rtol=1e-4)
    np.testing.assert_allclose(float(got.ct0), float(want.ct0), rtol=1e-4)


def test_heal_rolls_back_nan_and_repairs_columns():
    """heal: a NaN carry rolls back to the checkpoint (drift inf); a
    drifted column is patched and only that column."""
    _, port, r = _pair(seed=10)
    agg = agg_mod.init_aggregate_state(port, r)
    ckpt = ckpt_mod.take(agg, 0)
    poisoned = agg._replace(aggregate=agg.aggregate.clone())
    poisoned.aggregate[0, 0] = float("nan")
    assert bool(ckpt_mod.is_healthy(agg))
    assert not bool(ckpt_mod.is_healthy(poisoned))
    healed, observed, cols, rolled = ckpt_mod.heal(port, poisoned, ckpt)
    assert bool(rolled) and float(observed) == float("inf")
    assert bool(ckpt_mod.is_healthy(healed))
    drifted = agg._replace(aggregate=agg.aggregate.clone())
    drifted.aggregate[:, 2] += 0.5
    repaired, observed, cols = agg_mod.repair_columns(port, drifted, 1e-3)
    assert int(cols) == 1
    np.testing.assert_allclose(float(observed), 0.5, rtol=1e-3)
    assert torch.equal(repaired.aggregate[:, [0, 1, 3]],
                       drifted.aggregate[:, [0, 1, 3]])
    assert float(agg_mod.drift(port, repaired)) <= 1e-3
    assert ckpt_mod.restore(ckpt) is agg


def test_heal_matches_reference_on_a_clean_carry():
    """A clean carry passes the repair boundary unchanged on both sides."""
    ref, port, r = _pair(seed=11)
    jstate = jagg.init_aggregate_state(ref, jnp.asarray(r))
    jhealed, _, jcols, jrolled = jckpt.heal(
        ref, jstate, jckpt.take(jstate, 0))
    agg = agg_mod.init_aggregate_state(port, r)
    healed, _, cols, rolled = ckpt_mod.heal(port, agg, ckpt_mod.take(agg, 0))
    assert int(cols) == int(jcols) == 0
    assert bool(rolled) == bool(jrolled) is False
    assert torch.equal(healed.aggregate, agg.aggregate)
