"""The port's ``refine_sweeps`` (DESIGN.md §17) against the JAX
reference, on the CPU.

Where no random draw enters (``move_prob=1``) the port must reproduce the
reference exactly: moves, sweeps, per-sweep activity and the final
assignment, with per-sweep potentials within 1e-3 (closed forms summed in
another order).  The reference's jnp reduction cycles on framework c
(ROADMAP queue 3, caveat 1), so framework c is held against the
reference's kernel path (``dissat_fn=make_aggregate_dissat_fn(
interpret=True)``) and the jnp path is compared on ct only.

With ``move_prob < 1`` the coins come from a ``torch.Generator`` and
cannot match ``jax.random``'s bits, so only properties are checked: a
seed reproduces its run bitwise, runs converge and descend, and the mean
sweeps-to-equilibrium over 8 seeds lies within 25% of the reference's
over 8 keys.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.problem import make_problem as j_make_problem
from repro.core.refine import refine_sweeps as j_refine_sweeps
from repro.graphs.generators import (random_degree_graph, random_weights)
from repro.kernels import ops as jops
from repro_torch.core import costs
from repro_torch.core.problem import problem_from_arrays
from repro_torch.core.refine import refine_simultaneous, refine_sweeps
from repro_torch.kernels import ops

from test_torch_sparse import sparse_pair

torch.set_num_threads(1)

REL = 1e-3


def _dense_pair(n, k, seed):
    adj = random_degree_graph(n, seed=seed)
    b, c = random_weights(adj, seed=seed + 1, mean=5.0)
    jp = j_make_problem(c, b, np.linspace(0.5, 2.0, k), mu=8.0)
    port = problem_from_arrays(np.asarray(jp.adjacency),
                               np.asarray(jp.node_weights),
                               np.asarray(jp.speeds), np.asarray(jp.mu),
                               device="cpu")
    r0 = np.random.default_rng(seed + 2).integers(0, k, n).astype(np.int32)
    return jp, port, r0


@pytest.fixture(scope="module")
def pairs():
    jp, sp, r0 = sparse_pair(300, 8, seed=0)
    jd, dense, r0d = _dense_pair(200, 8, seed=1)
    return {"sparse": (jp, sp, r0), "dense": (jd, dense, r0d)}


def _ref_dissat(framework):
    """The reference's reduction to compare with: its kernel path on c
    (caveat 1), its jnp path on ct."""
    return (jops.make_aggregate_dissat_fn(interpret=True)
            if framework == "c" else None)


def _assert_same_run(got, want):
    (gres, (gc0, gct0, gact)), (wres, (wc0, wct0, wact)) = got, want
    assert int(gres.num_moves) == int(wres.num_moves)
    assert int(gres.num_turns) == int(wres.num_turns)
    assert bool(gres.converged) == bool(wres.converged)
    np.testing.assert_array_equal(gres.assignment.numpy(),
                                  np.asarray(wres.assignment))
    np.testing.assert_array_equal(gact.numpy(), np.asarray(wact))
    np.testing.assert_allclose(gc0.numpy(), np.asarray(wc0), rtol=REL)
    np.testing.assert_allclose(gct0.numpy(), np.asarray(wct0), rtol=REL)


MODES = {
    "degenerate": dict(moves_per_machine=1),
    "top4": dict(moves_per_machine=4),
    "unbounded": dict(moves_per_machine=None),
    "epsilon": dict(moves_per_machine=1, epsilon=1e-3),
}


# Dense unbounded is left out: with move_prob=1 that run never converges
# (some 9.4k moves in 48 sweeps at n=200) and amplifies the last bit of
# the initial dense aggregate, a product that PyTorch and XLA sum in their
# own orders; the port leaves the reference after 3 sweeps there, as the
# reference's own dense and sparse runs leave each other (ROADMAP queue 3).
# The sparse aggregate is bitwise the reference's, and sparse unbounded is
# held exactly.
CELLS = [(rep, mode) for rep in ("sparse", "dense") for mode in MODES
         if (rep, mode) != ("dense", "unbounded")]


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep,mode", CELLS)
def test_deterministic_modes_match_reference(pairs, rep, mode, framework):
    """``move_prob=1``: the degenerate §4.5 mode, top-M (M=4), unbounded
    and the ε floor reproduce the reference's run exactly."""
    jp, port, r0 = pairs[rep]
    kw = MODES[mode]
    want = j_refine_sweeps(jp, jnp.asarray(r0), framework, max_sweeps=48,
                           dissat_fn=_ref_dissat(framework), **kw)
    got = refine_sweeps(port, r0, framework, max_sweeps=48, **kw)
    _assert_same_run(got, want)


@pytest.mark.parametrize("theta", [None, 0.5])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["sparse", "dense"])
def test_degenerate_equals_refine_simultaneous_bitwise(pairs, rep,
                                                       framework, theta):
    """DESIGN.md §17: ``moves_per_machine=1, move_prob=1, epsilon=0`` is
    the §4.5 mode bit for bit — moves, activity and every per-sweep
    potential."""
    _, port, r0 = pairs[rep]
    res_s, outs_s = refine_simultaneous(port, r0, framework, max_sweeps=64,
                                        theta=theta)
    res_w, outs_w = refine_sweeps(port, r0, framework, max_sweeps=64,
                                  theta=theta, moves_per_machine=1,
                                  move_prob=1.0, epsilon=0.0)
    for a, b in zip(res_s[:5], res_w[:5]):
        assert torch.equal(a, b)
    for a, b in zip(outs_s, outs_w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("theta", [None, 0.5])
@pytest.mark.parametrize("framework", ["c", "ct"])
def test_sweep_fn_equals_dissat_fn(pairs, framework, theta):
    """The fused election (kernel 5's twin) == the per-node reduction
    (kernel 4's twin) plus the first-maximum election, bitwise, and both
    equal the reference's ``sweep_fn`` run on its moves."""
    jp, sp, r0 = pairs["sparse"]
    by_dissat = refine_sweeps(sp, r0, framework, max_sweeps=64, theta=theta,
                              dissat_fn=ops.make_edge_dissat_fn(sp))
    by_sweep = refine_sweeps(sp, r0, framework, max_sweeps=64, theta=theta,
                             sweep_fn=ops.make_edge_sweep_fn(sp))
    for a, b in zip(by_dissat[0][:5], by_sweep[0][:5]):
        assert torch.equal(a, b)
    for a, b in zip(by_dissat[1], by_sweep[1]):
        assert torch.equal(a, b)
    want = j_refine_sweeps(jp, jnp.asarray(r0), framework, max_sweeps=64,
                           theta=theta,
                           sweep_fn=jops.make_edge_sweep_fn(jp,
                                                            interpret=True))
    _assert_same_run(by_sweep, want)


def test_argument_validation_matches_reference(pairs):
    _, sp, r0 = pairs["sparse"]
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        refine_sweeps(sp, r0, "c", move_prob=0.5)
    with pytest.raises(ValueError, match="moves_per_machine=1"):
        refine_sweeps(sp, r0, "c", moves_per_machine=2,
                      sweep_fn=ops.make_edge_sweep_fn(sp))
    with pytest.raises(ValueError, match="not both"):
        refine_sweeps(sp, r0, "c", sweep_fn=ops.make_edge_sweep_fn(sp),
                      dissat_fn=ops.make_edge_dissat_fn(sp))
    with pytest.raises(TypeError):
        refine_sweeps(object(), r0, "c")


# ---------------------------------------------------------------------------
# move_prob < 1: properties and statistics
# ---------------------------------------------------------------------------

STAT_N, STAT_K, STAT_SWEEPS = 2048, 8, 256
COIN_CFG = dict(moves_per_machine=None, move_prob=0.5, epsilon=3e-3)


@pytest.fixture(scope="module")
def stat_pair():
    return sparse_pair(STAT_N, STAT_K, seed=0)


def _coin_run(sp, r0, seed, **kw):
    cfg = dict(COIN_CFG, **kw)
    return refine_sweeps(sp, r0, "c", max_sweeps=STAT_SWEEPS,
                         generator=torch.Generator().manual_seed(seed),
                         **cfg)


@pytest.mark.parametrize("mode", [None, 2])
def test_same_seed_reproduces_bitwise(stat_pair, mode):
    """One generator seed, one run: the adaptive coin (unbounded) and the
    flat coin (M=2) alike."""
    _, sp, r0 = stat_pair
    a = _coin_run(sp, r0, 7, moves_per_machine=mode)
    b = _coin_run(sp, r0, 7, moves_per_machine=mode)
    for x, y in zip(a[0][:5], b[0][:5]):
        assert torch.equal(x, y)
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    c = _coin_run(sp, r0, 8, moves_per_machine=mode)
    assert not torch.equal(a[1][0], c[1][0])


@pytest.mark.parametrize("mode", [None, 2])
def test_coin_runs_converge_and_descend(stat_pair, mode):
    """Each run reaches its ε-equilibrium below the starting potential,
    with a negative mean drop per active sweep (single sweeps may
    ascend: simultaneous moves are not unilateral)."""
    _, sp, r0 = stat_pair
    start = float(costs.global_cost_c0(sp, torch.from_numpy(r0)))
    for seed in range(3):
        res, (c0s, _, active) = _coin_run(sp, r0, seed,
                                          moves_per_machine=mode)
        assert bool(res.converged), seed
        n_active = int(active.sum())
        assert 1 <= n_active < STAT_SWEEPS
        pots = c0s.double().numpy()
        assert pots[n_active - 1] < start
        if n_active >= 2:
            assert (pots[n_active - 1] - pots[0]) / (n_active - 1) < 0.0


def test_mean_sweeps_matches_reference(stat_pair):
    """Unbounded mode with the adaptive coin: over 8 seeds the port's mean
    sweeps-to-equilibrium is within 25% of the reference's over 8 keys."""
    jp, sp, r0 = stat_pair
    want = []
    for key in range(8):
        res, _ = j_refine_sweeps(jp, jnp.asarray(r0), "c",
                                 max_sweeps=STAT_SWEEPS,
                                 key=jax.random.PRNGKey(key), **COIN_CFG)
        want.append(int(res.num_turns))
    got = [int(_coin_run(sp, r0, seed)[0].num_turns) for seed in range(8)]
    assert abs(np.mean(got) - np.mean(want)) <= 0.25 * np.mean(want), \
        (got, want)
