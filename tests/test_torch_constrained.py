"""The port's remaining core against the JAX reference, on the CPU:
simulated annealing, the capacity-constrained repairs, the §5.1
discrepancy count and the copied §2 baselines.

Annealing is held move for move: the reference's threefry draws are
reproduced here with ``jax.random`` (``split(key, steps)``, then per step
``split(k, 3)`` into ``randint``, ``randint``, ``uniform``) and fed to the
port's Metropolis chain, so the accepted count and the final assignment
must be equal and the potential trace within the reference's 1e-3
relative budget (DESIGN.md §10; the potentials are f32 sums whose order
differs between the libraries).  ``equalize_cardinality``,
``make_contiguous``, ``contiguous_stage_dp`` and ``count_discrepancies``
are exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import annealing as j_annealing
from repro.core import constrained as j_constrained
from repro.core.refine import count_discrepancies as j_count_discrepancies
from repro.core.refine import refine_traced as j_refine_traced
from repro.partitioners import baselines as j_baselines
from repro_torch.core import (count_discrepancies, equalize_cardinality,
                              make_contiguous, simulated_annealing)
from repro_torch.core import contiguous_stage_dp
from repro_torch.core.annealing import _metropolis
from repro_torch.core.problem import problem_from_arrays
from repro_torch.core.refine import refine_traced
from repro_torch.partitioners import baselines

from conftest import small_problem

torch.set_num_threads(1)

REL = 1e-3


def _port(prob):
    return problem_from_arrays(np.asarray(prob.adjacency),
                               np.asarray(prob.node_weights),
                               np.asarray(prob.speeds), np.asarray(prob.mu),
                               device="cpu")


@pytest.fixture(scope="module")
def paper_pair(paper_problem):
    _, prob = paper_problem
    return prob, _port(prob)


@pytest.fixture(scope="module")
def small_pair():
    _, prob = small_problem(n=24, k=3, seed=0)
    return prob, _port(prob)


def _reference_draws(key, steps: int, n: int, k: int):
    """The reference's per-step (node, dest, coin), drawn as its scan does."""
    def draw(step_key):
        k1, k2, k3 = jax.random.split(step_key, 3)
        return (jax.random.randint(k1, (), 0, n),
                jax.random.randint(k2, (), 0, k),
                jax.random.uniform(k3))
    nodes, dests, coins = jax.vmap(draw)(jax.random.split(key, steps))
    return tuple(torch.as_tensor(np.array(x)) for x in (nodes, dests, coins))


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("seed", [0, 3])
def test_annealing_matches_reference_move_for_move(paper_pair, framework,
                                                   seed):
    prob, port = paper_pair
    steps = 256
    r0 = np.random.default_rng(42).integers(0, 5, 230).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = j_annealing.simulated_annealing(prob, jnp.asarray(r0), key,
                                           framework, steps=steps)
    got = _metropolis(port, r0, *_reference_draws(key, steps, 230, 5),
                      framework)
    assert int(got.accepted) == int(want.accepted)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace),
                               rtol=REL)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=REL)


def test_annealing_public_entry_point_never_regresses(paper_pair):
    """``simulated_annealing`` draws from a torch.Generator: the best-so-far
    assignment is never worse than the start, and one generator seed gives
    one run."""
    from repro_torch.core import costs
    _, port = paper_pair
    r0 = np.random.default_rng(7).integers(0, 5, 230).astype(np.int32)
    runs = [simulated_annealing(port, r0, torch.Generator().manual_seed(5),
                                "c", steps=128) for _ in range(2)]
    start = float(costs.global_cost(port, torch.as_tensor(r0), "c"))
    assert float(runs[0].cost) <= start
    assert runs[0].trace.shape == (128,)
    assert int(runs[0].accepted) == int(runs[1].accepted)
    np.testing.assert_array_equal(runs[0].assignment.numpy(),
                                  runs[1].assignment.numpy())


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("start", ["random", "skewed"])
@pytest.mark.parametrize("which", ["paper", "small"])
def test_equalize_cardinality_matches_reference(paper_pair, small_pair,
                                                framework, start, which):
    prob, port = paper_pair if which == "paper" else small_pair
    n, k = port.num_nodes, port.num_machines
    rng = np.random.default_rng(11)
    if start == "random":
        r0 = rng.integers(0, k, n).astype(np.int32)
    else:                       # most nodes on machine 0: many repairs
        r0 = np.where(rng.random(n) < 0.7, 0,
                      rng.integers(0, k, n)).astype(np.int32)
    want = np.asarray(j_constrained.equalize_cardinality(
        prob, jnp.asarray(r0), framework))
    got = equalize_cardinality(port, r0, framework).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.bincount(got, minlength=k),
                                  np.full(k, n // k))


def test_equalize_cardinality_refuses_indivisible(small_pair):
    _, prob = small_problem(n=25, k=3, seed=0)
    with pytest.raises(ValueError, match="divisible"):
        equalize_cardinality(_port(prob), np.zeros(25, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_contiguous_and_stage_dp_match_reference(seed):
    rng = np.random.default_rng(seed)
    stages = int(rng.integers(2, 6))
    r = rng.integers(0, stages, 40).astype(np.int32)
    np.testing.assert_array_equal(
        make_contiguous(r, stages).numpy(),
        np.asarray(j_constrained.make_contiguous(jnp.asarray(r), stages)))
    np.testing.assert_array_equal(
        make_contiguous(torch.as_tensor(r), stages).numpy(),
        np.sort(r, kind="stable"))
    weights = rng.uniform(0.5, 3.0, 17)
    got, got_load = contiguous_stage_dp(weights, stages)
    want, want_load = j_constrained.contiguous_stage_dp(weights, stages)
    np.testing.assert_array_equal(got, want)
    assert got_load == want_load


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_count_discrepancies_matches_reference(paper_pair, framework):
    """On the reference's own trace the count is the same function; on the
    port's trace (the same moves, potentials within 1e-3) the same count."""
    prob, port = paper_pair
    r0 = np.random.default_rng(42).integers(0, 5, 230).astype(np.int32)
    j_res, j_trace = j_refine_traced(prob, jnp.asarray(r0), framework,
                                     max_turns=128)
    from repro.core import costs as j_costs
    other = (j_costs.global_cost_c0 if framework == "ct"
             else j_costs.global_cost_ct0)(prob, jnp.asarray(r0))
    want = int(j_count_discrepancies(j_trace, framework, other))
    from repro_torch.core.refine import Trace
    as_port = Trace(*(torch.as_tensor(np.array(x)) for x in j_trace))
    assert int(count_discrepancies(as_port, framework,
                                   torch.as_tensor(np.array(other)))) == want
    _, p_trace = refine_traced(port, r0, framework, max_turns=128)
    assert int(count_discrepancies(p_trace, framework, float(other))) == want


def test_baselines_equal_reference():
    from repro.graphs.generators import random_degree_graph, random_weights
    adj = random_degree_graph(60, seed=0, dmin=2, dmax=4)
    b, c = random_weights(adj, seed=1, mean=5.0)
    c, b = np.asarray(c), np.asarray(b)
    r0 = baselines.random_partition(60, 4, seed=3)
    np.testing.assert_array_equal(r0, j_baselines.random_partition(60, 4, 3))
    speeds = np.array([1.0, 1.0, 2.0, 4.0])
    np.testing.assert_array_equal(
        baselines.greedy_load_partition(b, speeds),
        j_baselines.greedy_load_partition(b, speeds))
    for name in ("kernighan_lin_refine", "nandy_loucks_refine"):
        np.testing.assert_array_equal(
            getattr(baselines, name)(c, r0),
            getattr(j_baselines, name)(c, r0))
    np.testing.assert_array_equal(baselines.spectral_bisection(c, 4),
                                  j_baselines.spectral_bisection(c, 4))
