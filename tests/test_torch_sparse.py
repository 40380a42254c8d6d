"""The port's sparse edge-list representation against the JAX reference,
on the CPU: the problem builder, its validation, the window-summed
aggregate, the sparse arms of costs and aggregate updates, and sparse ==
dense within the port on the DESIGN.md §13.3 grid.

Inputs are made with numpy from a seed and handed to both packages.  The
sparse aggregate and every carried aggregate update are held bitwise (the
port sums each slot in the reference's order); potentials to 1e-5
relative (closed forms summed in another order); move sequences exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import aggregate as jagg
from repro.core import costs as jcosts
from repro.core import sparse as jsparse
from repro.core.problem import make_problem as j_make_problem
from repro.core.refine import refine as j_refine
from repro.kernels import ops as jops
from repro.graphs.generators import (random_degree_graph,
                                     random_degree_graph_edges,
                                     random_weights, random_weights_edges)
from repro_torch.core import aggregate as agg_mod
from repro_torch.core import costs
from repro_torch.core import sparse
from repro_torch.core.problem import ProblemValidationError, \
    problem_from_arrays
from repro_torch.core.refine import (refine, refine_simultaneous,
                                     refine_traced)

torch.set_num_threads(1)

REL = 1e-5


def port_of(jp) -> sparse.SparseProblem:
    """The reference's sparse problem carried over bit for bit."""
    def t(x):
        return torch.from_numpy(np.array(x))
    return sparse.SparseProblem(
        senders=t(jp.senders), receivers=t(jp.receivers),
        edge_weights=t(jp.edge_weights), row_start=t(jp.row_start),
        node_weights=t(jp.node_weights), speeds=t(jp.speeds),
        mu=t(jp.mu).reshape(()), max_degree=jp.max_degree)


def sparse_pair(n, k, seed=0, speeds=None):
    """(reference sparse problem, port sparse problem, r0) on identical
    bits: the §5.1 edge-list graph of the sparse benchmark."""
    s, r = random_degree_graph_edges(n, seed=seed)
    b, w = random_weights_edges(n, s, seed=seed + 1, mean=5.0)
    if speeds is None:
        speeds = np.linspace(0.5, 2.0, k)
    jp = jsparse.make_sparse_problem(s, r, w, b, speeds, mu=8.0)
    r0 = np.random.default_rng(seed + 2).integers(0, k, n).astype(np.int32)
    return jp, port_of(jp), r0


def dense_pair(n, k, seed=0):
    """(port dense problem, its port sparse twin, r0) — the sparse
    benchmark's dense instance (equal speeds)."""
    adj = random_degree_graph(n, seed=seed)
    b, c = random_weights(adj, seed=seed + 1, mean=5.0)
    jp = j_make_problem(c, b, np.ones(k) / k, mu=8.0)
    port = problem_from_arrays(np.asarray(jp.adjacency),
                               np.asarray(jp.node_weights),
                               np.asarray(jp.speeds), np.asarray(jp.mu),
                               device="cpu")
    r0 = np.random.default_rng(seed + 2).integers(0, k, n).astype(np.int32)
    return port, sparse.sparse_from_dense(port), r0


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the problem: builder, converters, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(60, 4), (257, 8), (1024, 8)])
def test_make_sparse_problem_equals_reference(n, k):
    """Same dedupe, self-loop drop, (sender, receiver) sort, padding and
    speeds: every array equal exactly, and the same static max_degree."""
    rng = np.random.default_rng(n)
    s, r = random_degree_graph_edges(n, seed=n)
    # duplicates (both orientations) and self-loops in the input
    extra = rng.integers(0, n, 20)
    s = np.concatenate([s, r[:10], extra])
    r = np.concatenate([r, s[:10], extra])
    w = rng.uniform(0, 10, s.shape[0])
    b = rng.uniform(0, 10, n)
    speeds = rng.uniform(0.5, 2.0, k)
    want = jsparse.make_sparse_problem(s, r, w, b, speeds, mu=4.0)
    got = sparse.make_sparse_problem(s, r, w, b, speeds, mu=4.0,
                                     device="cpu")
    for field in ("senders", "receivers", "edge_weights", "row_start",
                  "node_weights", "speeds", "mu"):
        a, c = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.dtype == c.dtype, field
        _eq(a, c)
    assert got.max_degree == want.max_degree
    assert (got.num_nodes, got.num_machines, got.num_edges) == \
        (want.num_nodes, want.num_machines, want.num_edges)
    assert got.num_edges % sparse.EDGE_PAD_MULTIPLE == 0
    assert got.max_degree % sparse.DEGREE_PAD_MULTIPLE == 0


def _broken(jp, **fields):
    """The reference problem with some fields replaced (numpy arrays)."""
    import dataclasses
    return dataclasses.replace(jp, **{k: jnp.asarray(v)
                                      for k, v in fields.items()})


@pytest.mark.parametrize("case", ["nan", "negative", "range", "unsorted",
                                  "row_start", "window", "node_weights",
                                  "speeds", "shape"])
def test_validation_errors_match_reference(case):
    """Each malformed field raises ProblemValidationError with the
    reference's message."""
    jp, _, _ = sparse_pair(40, 3, seed=5)
    w = np.array(jp.edge_weights)
    s = np.array(jp.senders)
    rs = np.array(jp.row_start)
    fields = {
        "nan": dict(edge_weights=np.where(np.arange(w.size) == 3, np.nan,
                                          w).astype(np.float32)),
        "negative": dict(edge_weights=np.where(np.arange(w.size) == 3, -1.0,
                                               w).astype(np.float32)),
        "range": dict(receivers=np.full(w.size, 40, np.int32)),
        "unsorted": dict(senders=s[::-1].copy()),
        "row_start": dict(row_start=rs + 1),
        "window": dict(row_start=np.zeros_like(rs)),
        "node_weights": dict(node_weights=-np.ones(40, np.float32)),
        "speeds": dict(speeds=np.zeros(3, np.float32)),
        "shape": dict(receivers=np.zeros(w.size - 1, np.int32)),
    }[case]
    bad = _broken(jp, **fields)
    with pytest.raises(Exception) as want:
        bad.validate()
    with pytest.raises(ProblemValidationError) as got:
        port_of(bad).validate()
    assert str(got.value) == str(want.value)


def test_builder_rejects_what_the_reference_rejects():
    with pytest.raises(ProblemValidationError, match="out of range"):
        sparse.make_sparse_problem([0, 5], [1, 2], [1.0, 1.0], np.ones(3),
                                   np.ones(2), device="cpu")
    with pytest.raises(ProblemValidationError, match="disagree"):
        sparse.make_sparse_problem([0, 1], [1], [1.0, 1.0], np.ones(3),
                                   np.ones(2), device="cpu")


def test_dense_sparse_round_trip_exact():
    port, sp, _ = dense_pair(90, 4, seed=3)
    back = sparse.dense_from_sparse(sp)
    for field in ("adjacency", "node_weights", "speeds", "mu"):
        assert torch.equal(getattr(back, field), getattr(port, field))


def test_incident_windows_and_frontier_match_reference():
    """``node_incident_edges`` (one node and batched, including the
    clamped windows at the array end) and ``frontier_expand`` equal the
    reference's exactly."""
    jp, sp, _ = sparse_pair(200, 4, seed=7)
    nodes = np.array([0, 1, 57, 198, 199], np.int32)
    nbrs, ws = sparse.node_incident_edges_batched(sp, torch.from_numpy(nodes))
    for row, node in enumerate(nodes):
        want_r, want_w = jsparse.node_incident_edges(jp, jnp.int32(node))
        got_r, got_w = sparse.node_incident_edges(sp, int(node))
        for got in ((got_r, got_w), (nbrs[row], ws[row])):
            _eq(got[0].numpy(), want_r)
            _eq(got[1].numpy(), want_w)
    mask = np.zeros(200, bool)
    mask[[3, 100, 199]] = True
    for _ in range(3):
        want = np.asarray(jsparse.frontier_expand(jp, jnp.asarray(mask)))
        got = sparse.frontier_expand(sp, torch.from_numpy(mask)).numpy()
        _eq(got, want)
        mask = want.copy()


# ---------------------------------------------------------------------------
# costs and aggregate updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(60, 4), (513, 8), (1003, 8), (1024, 5)])
def test_sparse_aggregate_bitwise_equals_reference(n, k):
    """The window-summed aggregate equals the reference's segment_sum bit
    for bit: each slot sums its row's edges in the same order."""
    jp, sp, r0 = sparse_pair(n, k, seed=n)
    want = jcosts.adjacency_aggregate_sparse(jp, jnp.asarray(r0))
    got = costs.adjacency_aggregate_sparse(sp, torch.from_numpy(r0))
    _eq(got.numpy(), want)
    assert torch.equal(costs.problem_aggregate(sp, torch.from_numpy(r0), k),
                       got)


def test_sparse_potentials_match_reference():
    jp, sp, r0 = sparse_pair(300, 8, seed=4)
    rt, rj = torch.from_numpy(r0), jnp.asarray(r0)
    for fn, jfn in ((costs.total_cut_sparse, jcosts.total_cut_sparse),
                    (costs.problem_cut, jcosts.problem_cut),
                    (costs.global_cost_c0, jcosts.global_cost_c0),
                    (costs.global_cost_ct0, jcosts.global_cost_ct0),
                    (costs.load_imbalance, jcosts.load_imbalance)):
        np.testing.assert_allclose(float(fn(sp, rt)), float(jfn(jp, rj)),
                                   rtol=REL)
    for fw in ("c", "ct"):
        state = agg_mod.init_aggregate_state(sp, rt)
        np.testing.assert_allclose(
            costs.cost_matrix(sp, _state(sp, rt), fw).numpy(),
            np.asarray(jcosts.cost_matrix(jp, _jstate(jp, rj), fw)),
            rtol=REL, atol=1e-2)
        assert state.aggregate.shape == (300, 8)


def _state(sp, r):
    from repro_torch.core.problem import make_state
    return make_state(sp, r)


def _jstate(jp, r):
    from repro.core.problem import make_state
    return make_state(jp, r)


def test_non_problem_raises_type_error():
    with pytest.raises(TypeError, match="PartitionProblem or a SparseProblem"):
        costs.problem_aggregate(object(), torch.zeros(3, dtype=torch.int32),
                                2)
    with pytest.raises(TypeError):
        costs.global_cost_c0(object(), torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("move", [(5, 2), (199, 0), (0, 3)])
def test_sparse_apply_move_bitwise_equals_reference(move):
    """One unilateral move adds the node's incident window: the carried
    aggregate, loads and assignment equal the reference's exactly, the
    potential deltas to 1e-5."""
    jp, sp, r0 = sparse_pair(200, 4, seed=11)
    node, dest = move
    rt = torch.from_numpy(r0)
    got0 = agg_mod.init_aggregate_state(sp, rt)
    want0 = jagg.init_aggregate_state(jp, jnp.asarray(r0))
    src = int(r0[node])
    if src == dest:
        dest = (dest + 1) % 4
    got = agg_mod.apply_move(sp, got0, node, src, dest, True,
                             torch.sum(sp.node_weights))
    want = jagg.apply_move(jp, want0, jnp.int32(node), jnp.int32(src),
                           jnp.int32(dest), jnp.asarray(True),
                           jnp.sum(jp.node_weights))
    for field in ("assignment", "aggregate", "loads"):
        _eq(getattr(got, field).numpy(), getattr(want, field))
    for field in ("c0", "ct0"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=REL)
    kept = agg_mod.apply_move(sp, got0, node, src, dest, False,
                              torch.sum(sp.node_weights))
    for a, b in zip(kept, got0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", ["sweep", "moves"])
def test_sparse_apply_windows_bitwise_equals_reference(fn):
    """Simultaneous moves whose windows overlap (neighbours moving
    together, masked slots, garbage idle picks): the aggregate equals the
    reference's sequential scatter-add bit for bit, and a rebuild to 1e-5."""
    jp, sp, r0 = sparse_pair(300, 4, seed=13)
    rt = torch.from_numpy(r0)
    total = torch.sum(sp.node_weights)
    s = np.asarray(jp.senders)
    rcv = np.asarray(jp.receivers)
    # a node and two of its neighbours, one per machine where possible
    hub = 17
    nbrs = rcv[s == hub][:6]
    if fn == "sweep":
        picks = np.zeros(4, np.int32)
        will = np.zeros(4, bool)
        for node in [hub, *nbrs]:
            m = r0[node]
            if not will[m]:
                picks[m], will[m] = node, True
        dests = (np.arange(4) + 1) % 4
        got = agg_mod.apply_sweep(
            sp, agg_mod.init_aggregate_state(sp, rt), torch.from_numpy(picks),
            torch.from_numpy(dests.astype(np.int32)), torch.from_numpy(will),
            total)
        want = jagg.apply_sweep(
            jp, jagg.init_aggregate_state(jp, jnp.asarray(r0)),
            jnp.asarray(picks), jnp.asarray(dests, jnp.int32),
            jnp.asarray(will), jnp.sum(jp.node_weights))
    else:
        nodes = np.array([hub, *nbrs, 250, 251, 0], np.int32)
        dests = ((r0[nodes] + 1 + np.arange(nodes.size) % 3) % 4).astype(
            np.int32)
        will = np.ones(nodes.size, bool)
        will[-1] = False
        got = agg_mod.apply_moves(
            sp, agg_mod.init_aggregate_state(sp, rt), torch.from_numpy(nodes),
            torch.from_numpy(dests), torch.from_numpy(will), total)
        want = jagg.apply_moves(
            jp, jagg.init_aggregate_state(jp, jnp.asarray(r0)),
            jnp.asarray(nodes), jnp.asarray(dests), jnp.asarray(will),
            jnp.sum(jp.node_weights))
    for field in ("assignment", "aggregate", "loads"):
        _eq(getattr(got, field).numpy(), getattr(want, field))
    for field in ("c0", "ct0"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=REL)
    oracle = agg_mod.rebuild_state(sp, got.assignment, total)
    np.testing.assert_allclose(got.aggregate.numpy(),
                               oracle.aggregate.numpy(), rtol=REL, atol=1e-4)


def test_add_windows_sums_each_row_in_order():
    """Contributions to one row are added one at a time in index order,
    exactly as a sequential loop adds them; zero rows change nothing."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.uniform(0, 1e4, (9, 3)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 9, 60))
    contrib = torch.from_numpy(rng.uniform(-1e3, 1e3, (60, 3))
                               .astype(np.float32))
    contrib[::7] = 0.0
    want = base.clone()
    for m in range(60):
        want[targets[m]] = want[targets[m]] + contrib[m]
    got = agg_mod.add_windows(base, targets, contrib)
    assert torch.equal(got, want)
    assert torch.equal(base, base.clone())          # input untouched


@pytest.mark.parametrize("theta", [None, 0.5])
@pytest.mark.parametrize("framework", ["c", "ct"])
def test_sparse_refine_matches_reference_kernel_path(framework, theta):
    """Sparse ``refine`` (kernel 1's twin over the carried aggregate, the
    sparse rank-1 window update) reproduces the reference's kernel path
    exactly: moves, turns and assignment; ``verify_every`` changes
    nothing and sees only f32 drift."""
    jp, sp, r0 = sparse_pair(400, 8, seed=3)
    want = j_refine(jp, jnp.asarray(r0), framework, theta=theta,
                    dissat_fn=jops.make_aggregate_dissat_fn(interpret=True))
    got = refine(sp, r0, framework, theta=theta)
    assert bool(want.converged) and bool(got.converged)
    assert (int(got.num_moves), int(got.num_turns)) == \
        (int(want.num_moves), int(want.num_turns))
    _eq(got.assignment.numpy(), want.assignment)
    checked = refine(sp, r0, framework, theta=theta, verify_every=64)
    assert torch.equal(checked.assignment, got.assignment)
    scale = abs(float(costs.global_cost(sp, got.assignment, framework)))
    assert float(checked.aggregate_drift) <= 1e-3 * scale


# ---------------------------------------------------------------------------
# sparse == dense within the port on the DESIGN.md §13.3 grid
# ---------------------------------------------------------------------------

GRID = [(fw, th) for fw in ("c", "ct") for th in (None, 0.5)]


@pytest.fixture(scope="module")
def grid_pair():
    return dense_pair(256, 8, seed=0)


@pytest.mark.parametrize("framework,theta", GRID)
def test_refine_sparse_equals_dense(grid_pair, framework, theta):
    dense, sp, r0 = grid_pair
    a = refine(dense, r0, framework, theta=theta)
    b = refine(sp, r0, framework, theta=theta)
    assert bool(a.converged) and bool(b.converged)
    assert (int(a.num_moves), int(a.num_turns)) == \
        (int(b.num_moves), int(b.num_turns))
    assert torch.equal(a.assignment, b.assignment)


@pytest.mark.parametrize("framework,theta", GRID)
def test_refine_traced_sparse_equals_dense(grid_pair, framework, theta):
    dense, sp, r0 = grid_pair
    ra, ta = refine_traced(dense, r0, framework, max_turns=256, theta=theta)
    rb, tb = refine_traced(sp, r0, framework, max_turns=256, theta=theta)
    for field in ("moved", "node", "source", "dest", "active"):
        assert torch.equal(getattr(ta, field), getattr(tb, field)), field
    for field in ("c0", "ct0"):
        np.testing.assert_allclose(getattr(tb, field).numpy(),
                                   getattr(ta, field).numpy(), rtol=1e-3)
    assert torch.equal(ra.assignment, rb.assignment)


@pytest.mark.parametrize("framework,theta", GRID)
def test_refine_simultaneous_sparse_equals_dense(grid_pair, framework,
                                                 theta):
    dense, sp, r0 = grid_pair
    ra, (c0a, ct0a, acta) = refine_simultaneous(dense, r0, framework,
                                                max_sweeps=64, theta=theta)
    rb, (c0b, ct0b, actb) = refine_simultaneous(sp, r0, framework,
                                                max_sweeps=64, theta=theta)
    assert int(ra.num_moves) == int(rb.num_moves)
    assert torch.equal(acta, actb)
    assert torch.equal(ra.assignment, rb.assignment)
    np.testing.assert_allclose(c0b.numpy(), c0a.numpy(), rtol=1e-3)
    np.testing.assert_allclose(ct0b.numpy(), ct0a.numpy(), rtol=1e-3)
