"""The port's distributed refinement runtime (``repro_torch.distributed``)
against its own single controller and the JAX reference, on the CPU.

Within the port, the sequential drivers are bitwise the controller: every
trace field, the assignment, the loads and the move and turn counts, at
every shard count, on both frameworks, with and without theta.  Values
reduced from per-shard partials (the traced drivers' initial potentials,
the sweep drivers' loads and potentials) are bitwise with one shard and
held to 1e-6 relative with more (1e-5 for the sweeps' potentials, whose
closed form cancels): they are f32 sums of S partial sums.

Against the reference: on ct the port equals the reference's ``jnp``
drivers exactly in every integer outcome — moves, nodes, sources,
destinations, assignments, move and turn counts; gains, loads and
potentials are held to the reference's budget (rtol 1e-3, as
``test_torch_refine.py`` holds the controller): the port's controller
already rounds some costs differently from the reference's.  On c the reference's
``jnp`` drivers cycle (ROADMAP queue 3, caveat 1), so the port is held to
the reference's ``cost_fn="pallas"`` drivers (the Pallas kernels in
interpret mode): equal assignments, move and turn counts.

The collective driver runs in-process as a gloo group of one, and in one
test as 4 gloo ranks in subprocesses that meet on a ``FileStore`` in
``tmp_path``.  The fault layer and the DES's distributed backend are in
``test_torch_faults.py``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import repro.distributed as JD
from repro.core.problem import make_problem as j_make_problem
from repro.graphs.generators import random_degree_graph, random_weights
from repro_torch import distributed as PD
from repro_torch.core import costs
from repro_torch.core.problem import (make_problem, make_state,
                                     problem_from_arrays)
from repro_torch.core.refine import (refine, refine_simultaneous,
                                     refine_sweeps, refine_traced)
from repro_torch.distributed import accounting, protocol
from repro_torch.distributed.views import pad_rows
from repro_torch.graphs import generators as pgen
from repro_torch.kernels import ops

torch.set_num_threads(1)

SPEEDS = [0.1, 0.2, 0.3, 0.3, 0.1]
REL = 1e-3          # the reference's float budget (DESIGN.md §10)


def _pair(n=96, k=5, seed=0, mu=8.0):
    """(reference problem, port problem, r0) on identical bits."""
    adj = random_degree_graph(n, seed=seed)
    b, c = random_weights(adj, seed=seed + 1, mean=5.0)
    speeds = SPEEDS[:k] if k <= 5 else np.ones(k) / k
    jp = j_make_problem(c, b, speeds, mu=mu)
    pp = problem_from_arrays(np.asarray(jp.adjacency),
                             np.asarray(jp.node_weights),
                             np.asarray(jp.speeds), np.asarray(jp.mu),
                             device="cpu")
    r0 = np.random.default_rng(seed + 2).integers(0, k, n).astype(np.int32)
    return jp, pp, r0


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _eq(a, b, label=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (label, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=label)


RESULT = ("assignment", "loads", "num_moves", "num_turns", "converged")


def _same_result(want, got, fields=RESULT, label=""):
    for f in fields:
        _eq(getattr(want, f), getattr(got, f), f"{label} {f}")


def _same_outcome(want, got):
    """Against the reference: the assignment, and the move and turn counts
    by value (the packages' count dtypes differ)."""
    _eq(want.assignment, got.assignment, "assignment")
    assert int(got.num_moves) == int(want.num_moves)
    assert int(got.num_turns) == int(want.num_turns)


# ---------------------------------------------------------------------------
# views and protocol
# ---------------------------------------------------------------------------

def test_views_partition_and_padding(pair):
    _, prob, _ = pair
    views = PD.build_views(prob, 5)                  # 96 -> 5 shards of 20
    assert views.row_block.shape == (5, 20, 96)
    assert views.row_block.is_contiguous()
    assert int(views.valid.sum()) == 96
    flat = views.flat_rows()
    assert torch.equal(flat[:96], prob.adjacency)
    assert torch.equal(flat[96:], torch.zeros(4, 96))
    ids = views.ids[views.valid]
    assert torch.equal(torch.sort(ids).values, torch.arange(96,
                                                            dtype=torch.int32))
    # S dividing N: the blocks are a view of the adjacency, no copy
    even = PD.build_views(prob, 4)
    assert even.row_block.data_ptr() == prob.adjacency.data_ptr()
    with pytest.raises(ValueError, match="num_shards"):
        PD.build_views(prob, 97)


@pytest.mark.parametrize("num_shards", [1, 3, 5])
def test_boundary_stats_equal_reference(pair, num_shards):
    jp, prob, _ = pair
    want = JD.boundary_stats(jp, num_shards)
    got = PD.boundary_stats(prob, num_shards)
    for f in ("boundary_nodes", "ghost_nodes", "cross_edges"):
        _eq(getattr(want, f), getattr(got, f), f)
    assert (got.total_ghosts, got.total_boundary) == (want.total_ghosts,
                                                      want.total_boundary)


def test_block_aggregates_are_controller_rows(pair):
    _, prob, r0 = pair
    full = costs.problem_aggregate(prob, torch.as_tensor(r0), 5)
    blocks = protocol.block_aggregates(prob, torch.as_tensor(r0), 3)
    assert blocks.shape == (3, 32, 5)
    assert torch.equal(blocks.reshape(-1, 5)[:96], full)
    padded = pad_rows(full, 5)                       # 96 -> 5 x 20 rows
    assert padded.shape == (5, 20, 5)
    assert torch.equal(padded.reshape(-1, 5)[96:], torch.zeros(4, 5))


def test_elect_tie_break_and_nan():
    cands = protocol.Candidate(
        gain=torch.tensor([0.5, 2.0, 2.0, -float("inf")]),
        node=torch.tensor([3, 40, 17, 90], dtype=torch.int32),
        dest=torch.tensor([1, 2, 0, 1], dtype=torch.int32),
        weight=torch.tensor([1.0, 2.0, 3.0, 4.0]))
    w = protocol.elect(cands, 1e-6)
    assert bool(w.moved) and int(w.node) == 17 and int(w.shard) == 2
    assert int(w.dest) == 0 and float(w.weight) == 3.0
    nan = cands._replace(gain=torch.tensor([0.5, float("nan"), 2.0, 1.0]))
    w = protocol.elect(nan, 1e-6)
    assert not bool(w.moved) and torch.isnan(w.gain)
    # degraded: the NaN is not eligible; lag raises the shard's bar
    w = protocol.elect_degraded(nan, 1e-6, torch.tensor([0, 0, 50, 0]), 0.05)
    assert bool(w.moved) and int(w.node) == 90 and int(w.shard) == 3


# ---------------------------------------------------------------------------
# distributed == controller, bitwise, within the port
# ---------------------------------------------------------------------------

def _check_traced(prob, r0, fw, s, theta, cost_fn="jnp"):
    # the runs converge within 60 turns; the rest are masked turns
    want, wtr = refine_traced(prob, r0, fw, max_turns=160, theta=theta)
    got, gtr = PD.refine_distributed_traced(prob, r0, fw, num_shards=s,
                                            max_turns=160, theta=theta,
                                            cost_fn=cost_fn)
    _same_result(want, got, label="traced")
    for f in wtr._fields:
        if f in ("c0", "ct0") and s > 1:
            # the initial potentials are sums of S shard partials
            np.testing.assert_allclose(getattr(gtr, f).numpy(),
                                       getattr(wtr, f).numpy(), rtol=1e-6)
        else:
            _eq(getattr(wtr, f), getattr(gtr, f), f"trace {f}")


def _check_sweeps(prob, r0, fw, s, theta):
    want, wout = refine_simultaneous(prob, r0, fw, max_sweeps=64,
                                     theta=theta)
    got, gout = PD.refine_distributed_simultaneous(
        prob, r0, fw, num_shards=s, max_sweeps=64, theta=theta)
    exact = RESULT if s == 1 else ("assignment", "num_moves", "num_turns",
                                   "converged")
    _same_result(want, got, exact, "sweeps")
    _eq(wout[2], gout[2], "active")
    for a, b in zip(wout[:2], gout[:2]):
        if s == 1:
            _eq(a, b, "potentials")
        else:
            # loads, squared loads and cut are sums of S shard partials,
            # and C_0's closed form cancels (the reference's own test of
            # distributed against controller sweeps allows 1e-4)
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.loads.numpy(), want.loads.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("theta", [None, 0.5])
@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("driver", ["plain", "traced", "sweep"])
def test_distributed_equals_controller(pair, driver, framework, num_shards,
                                       theta):
    _, prob, r0 = pair
    if driver == "plain":
        want = refine(prob, r0, framework, theta=theta)
        got = PD.refine_distributed(prob, r0, framework,
                                    num_shards=num_shards, theta=theta)
        assert bool(got.converged)
        _same_result(want, got)
    elif driver == "traced":
        _check_traced(prob, r0, framework, num_shards, theta)
    else:
        _check_sweeps(prob, r0, framework, num_shards, theta)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_kernel3_paths_equal_controller_on_kernel1(pair, framework):
    """``cost_fn="pallas"`` reduces the traced and sweep drivers on kernel
    3's twin: bitwise the controller reducing with kernel 1's (``refine``
    for the traced run's moves, ``refine_sweeps(dissat_fn=...)``)."""
    _, prob, r0 = pair
    want = refine(prob, r0, framework, max_turns=300)
    got, tr = PD.refine_distributed_traced(prob, r0, framework,
                                           num_shards=3, max_turns=300,
                                           cost_fn="pallas")
    _same_result(want, got, ("assignment", "loads", "converged"),
                 "traced kernel 3")
    assert int(got.num_moves) == int(want.num_moves)
    assert int(got.num_turns) == int(want.num_turns)
    want, wout = refine_sweeps(prob, r0, framework, max_sweeps=64,
                               dissat_fn=ops.make_aggregate_dissat_fn())
    got, gout = PD.refine_distributed_simultaneous(
        prob, r0, framework, num_shards=1, max_sweeps=64, cost_fn="pallas")
    _same_result(want, got, label="sweeps kernel 3")
    for a, b in zip(wout, gout):
        _eq(a, b)


@pytest.mark.parametrize("cost_fn", ["jnp", "pallas"])
@pytest.mark.parametrize("num_shards", [1, 3])
def test_recompute_path_equals_controller(pair, cost_fn, num_shards):
    """``incremental=False``: the shards rebuild their cost rows every
    turn (kernel 2's twin on the row blocks for ``"pallas"``), bitwise the
    controller's recompute turns (``costs.cost_matrix`` or kernel 2 over
    the whole matrix)."""
    _, prob, r0 = pair
    fn = ops.make_core_cost_matrix_fn() if cost_fn == "pallas" else None
    for fw in ("c", "ct"):
        want = refine(prob, r0, fw, incremental=False, cost_matrix_fn=fn)
        got = PD.refine_distributed(prob, r0, fw, num_shards=num_shards,
                                    incremental=False, cost_fn=cost_fn)
        _same_result(want, got, label=f"{fw} recompute")
    want, wtr = refine_traced(prob, r0, "ct", max_turns=120,
                              incremental=False)
    got, gtr = PD.refine_distributed_traced(
        prob, r0, "ct", num_shards=num_shards, max_turns=120,
        incremental=False)
    _same_result(want, got, label="traced recompute")
    for f in ("moved", "node", "source", "dest", "gain", "active"):
        _eq(getattr(wtr, f), getattr(gtr, f), f)
    for f in ("c0", "ct0"):
        # recomputed every turn from S shard partials
        np.testing.assert_allclose(getattr(gtr, f).numpy(),
                                   getattr(wtr, f).numpy(), rtol=1e-5)


def test_recompute_sweeps_follow_incremental_moves(pair):
    _, prob, r0 = pair
    a, (c0a, _, acta) = PD.refine_distributed_simultaneous(
        prob, r0, "c", num_shards=3, max_sweeps=32)
    b, (c0b, _, actb) = PD.refine_distributed_simultaneous(
        prob, r0, "c", num_shards=3, max_sweeps=32, incremental=False)
    _same_result(a, b, ("assignment", "num_moves", "num_turns"))
    _eq(acta, actb)
    np.testing.assert_allclose(c0b.numpy(), c0a.numpy(), rtol=1e-5)


def test_unknown_cost_fn_raises(pair):
    _, prob, r0 = pair
    for fn in (PD.refine_distributed, PD.refine_distributed_traced,
               PD.refine_distributed_simultaneous):
        with pytest.raises(ValueError, match="cost_fn"):
            fn(prob, r0, "c", num_shards=3, cost_fn="typo")
    with pytest.raises(ValueError, match="cost_fn"):
        PD.refine_distributed(prob, r0, "c", incremental=False,
                              cost_fn="typo")
    # run telemetry is ported: a recorder gets the run's reconciled wire
    from repro_torch.obs import Recorder
    rec = Recorder()
    PD.refine_distributed(prob, r0, "c", recorder=rec)
    wire = [e for e in rec.events if e["kind"] == "wire"]
    assert len(wire) == 1 and wire[0]["ok"]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 5])
def test_matches_reference_ct(pair, num_shards):
    jp, prob, r0 = pair
    jr = jnp.asarray(r0)
    want = JD.refine_distributed(jp, jr, "ct", num_shards=num_shards)
    got = PD.refine_distributed(prob, r0, "ct", num_shards=num_shards)
    _same_outcome(want, got)
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_allclose(got.loads.numpy(), np.asarray(want.loads),
                               rtol=REL)
    want, wtr = JD.refine_distributed_traced(jp, jr, "ct",
                                             num_shards=num_shards,
                                             max_turns=200)
    got, gtr = PD.refine_distributed_traced(prob, r0, "ct",
                                            num_shards=num_shards,
                                            max_turns=200)
    for f in ("moved", "node", "source", "dest", "active"):
        _eq(getattr(wtr, f), getattr(gtr, f), f)
    np.testing.assert_allclose(gtr.gain.numpy(), np.asarray(wtr.gain),
                               rtol=REL, atol=1e-2)
    for f in ("c0", "ct0"):
        np.testing.assert_allclose(getattr(gtr, f).numpy(),
                                   np.asarray(getattr(wtr, f)), rtol=REL)
    want, (wc0, _, wact) = JD.refine_distributed_simultaneous(
        jp, jr, "ct", num_shards=num_shards, max_sweeps=48)
    got, (gc0, _, gact) = PD.refine_distributed_simultaneous(
        prob, r0, "ct", num_shards=num_shards, max_sweeps=48)
    _same_outcome(want, got)
    _eq(wact, gact)
    np.testing.assert_allclose(gc0.numpy(), np.asarray(wc0), rtol=REL)


@pytest.mark.parametrize("num_shards", [5])
def test_matches_reference_kernel_path_c(pair, num_shards):
    """Framework c against the reference's ``cost_fn="pallas"`` drivers
    (its fused kernels in interpret mode), which converge: the whole run's
    assignment, moves, turns; the traced run's move sequence."""
    jp, prob, r0 = pair
    jr = jnp.asarray(r0)
    want = JD.refine_distributed(jp, jr, "c", num_shards=num_shards,
                                 cost_fn="pallas")
    got = PD.refine_distributed(prob, r0, "c", num_shards=num_shards)
    assert bool(want.converged) and bool(got.converged)
    _same_outcome(want, got)
    want, wtr = JD.refine_distributed_traced(
        jp, jr, "c", num_shards=num_shards, max_turns=120, cost_fn="pallas")
    got, gtr = PD.refine_distributed_traced(
        prob, r0, "c", num_shards=num_shards, max_turns=120,
        cost_fn="pallas")
    for f in ("moved", "node", "source", "dest", "active"):
        _eq(getattr(wtr, f), getattr(gtr, f), f)
    np.testing.assert_allclose(gtr.gain.numpy(), np.asarray(wtr.gain),
                               rtol=2e-4, atol=2e-2)


# ---------------------------------------------------------------------------
# wire accounting: measured bytes == the ledger, byte for byte
# ---------------------------------------------------------------------------

def _reconciled(stats, k, wire, **flags):
    led = PD.ledger_for_run(stats, k, int(wire.rounds), **flags)
    return accounting.reconcile(led, wire)


@pytest.mark.parametrize("incremental", [True, False])
def test_measured_wire_matches_ledger(incremental):
    _, prob, r0 = _pair(n=96, k=5, seed=7)
    s, k = 6, 5
    stats = PD.boundary_stats(prob, s)
    res, wire = PD.refine_distributed(prob, r0, num_shards=s,
                                      incremental=incremental,
                                      measure_wire=True)
    assert wire.rounds == int(res.num_turns)
    assert _reconciled(stats, k, wire, incremental=incremental).ok
    res_t, _, wire_t = PD.refine_distributed_traced(
        prob, r0, num_shards=s, max_turns=128, incremental=incremental,
        measure_wire=True)
    assert wire_t.rounds == int(res_t.num_turns)
    assert _reconciled(stats, k, wire_t, traced=True,
                       incremental=incremental).ok
    res_s, _, wire_s = PD.refine_distributed_simultaneous(
        prob, r0, num_shards=s, max_sweeps=32, incremental=incremental,
        measure_wire=True)
    assert wire_s.rounds == int(res_s.num_turns)
    assert _reconciled(stats, k, wire_s, simultaneous=True,
                       incremental=incremental).ok
    plain = PD.refine_distributed(prob, r0, num_shards=s,
                                  incremental=incremental)
    assert torch.equal(plain.assignment, res.assignment)
    led = PD.ledger_for_run(stats, k, wire.rounds + 1)
    with pytest.raises(ValueError, match="rounds"):
        accounting.reconcile(led, wire)


def test_per_round_payload_independent_of_n():
    per_round = []
    for n in (64, 256):
        adj = pgen.random_degree_graph(n, seed=1)
        b, c = pgen.random_weights(adj, seed=2, mean=5.0)
        prob = make_problem(c, b, np.ones(4) / 4, mu=8.0, device="cpu")
        r0 = np.random.default_rng(3).integers(0, 4, n).astype(np.int32)
        res, wire = PD.refine_distributed(prob, r0, "c", num_shards=4,
                                          max_turns=256, measure_wire=True)
        led = PD.ledger_for_run(PD.boundary_stats(prob, 4), 4, wire.rounds)
        assert accounting.reconcile(led, wire).ok and led.rounds > 0
        per_round.append(led.per_round_bytes)
    assert per_round[0] == per_round[1] == 4 * protocol.CANDIDATE_BYTES


# ---------------------------------------------------------------------------
# the collective driver
# ---------------------------------------------------------------------------

def test_shard_map_group_of_one(pair):
    """With no process group the driver makes a gloo group of one on a
    FileStore, runs the collective code path, and destroys the group."""
    _, prob, r0 = pair
    assert not dist.is_initialized()
    for fw in ("c", "ct"):
        want = refine(prob, r0, fw, theta=0.25)
        got = PD.refine_distributed_shard_map(prob, r0, fw, num_shards=1,
                                              theta=0.25)
        _same_result(want, got)
        assert not dist.is_initialized()
    got, wire = PD.refine_distributed_shard_map(prob, r0, "c",
                                                num_shards=1,
                                                measure_wire=True)
    assert _reconciled(PD.boundary_stats(prob, 1), 5, wire).ok
    with pytest.raises(ValueError, match="need 3 devices"):
        PD.refine_distributed_shard_map(prob, r0, num_shards=3)
    with pytest.raises(ValueError, match="need 2 devices"):
        PD.refine_distributed_shard_map(prob, r0, num_shards=2,
                                        devices=["cpu"])
    assert not dist.is_initialized()


_RANK = textwrap.dedent("""
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    from repro_torch.core.problem import make_problem
    from repro_torch.graphs.generators import (random_degree_graph,
                                               random_weights)
    from repro_torch.distributed import refine_distributed_shard_map
    adj = random_degree_graph(64, seed=0)
    b, c = random_weights(adj, seed=1, mean=5.0)
    prob = make_problem(c, b, [0.2, 0.3, 0.5], mu=4.0, device="cpu")
    r0 = np.random.default_rng(0).integers(0, 3, 64).astype(np.int32)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res, wire = refine_distributed_shard_map(
            prob, r0, "c", num_shards=world, measure_wire=True)
        left = dist.is_initialized()
    finally:
        dist.destroy_process_group()
    np.savez(out, assignment=res.assignment.numpy(),
             loads=res.loads.numpy(), moves=int(res.num_moves),
             turns=int(res.num_turns), converged=bool(res.converged),
             payload=wire.payload_bytes, group_kept=left,
             group_gone=not dist.is_initialized())
""")


def test_shard_map_four_gloo_ranks(tmp_path):
    """4 ranks, one shard each, exchanging candidates with gloo
    ``all_gather``: every rank ends on the emulated driver's and the
    controller's run bitwise, converged, and the caller's group is used,
    not replaced."""
    world = 4
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), store,
         str(tmp_path / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    adj = pgen.random_degree_graph(64, seed=0)
    b, c = pgen.random_weights(adj, seed=1, mean=5.0)
    prob = make_problem(c, b, [0.2, 0.3, 0.5], mu=4.0, device="cpu")
    r0 = np.random.default_rng(0).integers(0, 3, 64).astype(np.int32)
    want = refine(prob, r0, "c")
    emulated = PD.refine_distributed(prob, r0, "c", num_shards=world)
    _same_result(want, emulated)
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        _eq(want.assignment, got["assignment"], f"rank {r}")
        _eq(want.loads, got["loads"], f"rank {r}")
        assert int(got["moves"]) == int(want.num_moves)
        assert int(got["turns"]) == int(want.num_turns)
        assert bool(got["converged"])
        assert bool(got["group_kept"]) and bool(got["group_gone"])
        assert int(got["payload"]) == (int(want.num_turns) * world
                                       * protocol.CANDIDATE_BYTES)


def test_state_after_make_state_is_replicated_start(pair):
    """The drivers' replicated start is ``make_state``: loads by the
    controller's one-hot product."""
    _, prob, r0 = pair
    state = make_state(prob, r0)
    res = PD.refine_distributed(prob, r0, "c", num_shards=3, max_turns=0)
    assert torch.equal(res.loads, state.loads)
    assert int(res.num_turns) == 0
