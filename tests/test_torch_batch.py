"""The port's batched fleets (``repro_torch.core.batch``, DESIGN.md §12) and
kernel 3's twin, on the CPU.

Within the port, every element of a batched run must equal its own looped
run BITWISE: move sequences, assignments, loads, gains, turn and move
counts, drift and the carried potentials.  (The reference allows the
carried potentials a last-ULP difference because XLA may fuse
``c0 + dc0`` differently under ``vmap``; the port runs the same separate
ops in both layouts, so it is held to bitwise.)

Against the reference, on the same numpy-made inputs: each element of
``refine_batched`` equals the reference's kernel-path ``refine_batched``
exactly in assignment and move and turn counts.  Traced runs are held as
``tests/test_torch_refine.py`` holds ``refine_traced``: the reference's
jnp reduction cycles on framework c (ROADMAP queue 3, caveat 1), so ct is
compared exactly and c up to the reference's first source == dest move.
Kernel 3's twin is held to the batch-grid Pallas kernel in interpret mode
at kernel 1's budget (``best`` exact; rtol 2e-4, atol 2e-2), and to kernel
1's twin element by element, bitwise.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import batch as jbatch
from repro.core import sparse as jsparse
from repro.core.problem import make_problem as j_make_problem
from repro.graphs.generators import (preferential_attachment,
                                     random_degree_graph,
                                     random_degree_graph_edges,
                                     random_weights, random_weights_edges,
                                     specialized_geometric)
from repro.kernels import ops as jops
from repro.kernels.dissatisfaction import \
    dissatisfaction_from_aggregate_batched_pallas
from repro_torch.core import batch
from repro_torch.core.problem import problem_from_arrays
from repro_torch.core.refine import (RefineResult, refine,
                                     refine_simultaneous, refine_sweeps,
                                     refine_traced)
from repro_torch.kernels import dissatisfaction as D
from repro_torch.kernels import ops

from test_torch_sparse import port_of

torch.set_num_threads(1)

K = 4
GENERATORS = (random_degree_graph,
              lambda n, s: preferential_attachment(n, s, m=2),
              specialized_geometric)


def _dense_fleet(num, n=40, seed0=0):
    """(reference problems, port problems, r0s): mixed graph families
    (n >= 16 for the shared geometric generator, caveat 2), speeds and
    starts per element, on identical bits."""
    jps, ports, r0s = [], [], []
    for s in range(num):
        adj = GENERATORS[s % len(GENERATORS)](n, seed0 + s)
        b, c = random_weights(adj, seed=seed0 + s + 77, mean=5.0)
        rng = np.random.default_rng(seed0 + s)
        speeds = rng.uniform(0.5, 2.0, K)
        jp = j_make_problem(c, b, speeds / speeds.sum(), mu=8.0)
        jps.append(jp)
        ports.append(problem_from_arrays(
            np.asarray(jp.adjacency), np.asarray(jp.node_weights),
            np.asarray(jp.speeds), np.asarray(jp.mu), device="cpu"))
        r0s.append(rng.integers(0, K, n).astype(np.int32))
    return jps, ports, r0s


def _sparse_fleet(num, n=64, seed0=0):
    """The same for sparse problems: one padded edge count and
    max_degree across the fleet (pad multiples 1024 and 32)."""
    jps, ports, r0s = [], [], []
    for s in range(num):
        snd, rcv = random_degree_graph_edges(n, seed=seed0 + s)
        b, w = random_weights_edges(n, snd, seed=seed0 + s + 1, mean=5.0)
        rng = np.random.default_rng(seed0 + s + 2)
        jp = jsparse.make_sparse_problem(
            snd, rcv, w, b, rng.uniform(0.5, 2.0, K), mu=8.0,
            pad_edges_multiple=1024, pad_degree_multiple=32)
        jps.append(jp)
        ports.append(port_of(jp))
        r0s.append(rng.integers(0, K, n).astype(np.int32))
    return jps, ports, r0s


def _fleet(rep, num, seed0=0):
    return (_dense_fleet if rep == "dense" else _sparse_fleet)(num,
                                                               seed0=seed0)


def _theta(kind, num, n):
    if kind is None:
        return None, [None] * num
    if kind == "scalar":
        return 2.5, [2.5] * num
    per = np.stack([np.random.default_rng(9 + i).uniform(0, 3, n)
                    .astype(np.float32) for i in range(num)])
    return per, list(per)


def _assert_element(looped, batched, b, context):
    """Every tensor of the looped result equals element b of the batched
    one, bitwise (dtype included)."""
    got = batch._tensors(batch.unstack_pytree(batched, b))
    want = batch._tensors(looped)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (context, b, i)
        assert torch.equal(g, w), (context, b, i, g, w)


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------

def test_stack_problems_is_a_problem_with_leading_axis():
    _, ports, _ = _dense_fleet(3)
    stacked = batch.stack_problems(ports)
    assert type(stacked) is type(ports[0])
    assert stacked.adjacency.shape == (3, 40, 40)
    assert stacked.node_weights.shape == (3, 40)
    assert stacked.speeds.shape == (3, K)
    assert stacked.mu.shape == (3,)
    assert batch.batch_size(stacked) == 3
    assert batch.problem_shape_key(ports[0]) == ("PartitionProblem", 40, K)
    for b in range(3):
        elem = batch.unstack_pytree(stacked, b)
        for got, want in zip(batch._tensors(elem), batch._tensors(ports[b])):
            assert torch.equal(got, want)


def test_stack_sparse_keeps_max_degree_and_shape_key():
    jps, ports, _ = _sparse_fleet(3)
    stacked = batch.stack_problems(ports)
    e = ports[0].num_edges
    assert stacked.senders.shape == (3, e)
    assert stacked.row_start.shape == (3, 64)
    assert stacked.max_degree == ports[0].max_degree == 32
    assert batch.problem_shape_key(ports[1]) == \
        ("SparseProblem", 64, K, e, 32) == jbatch.problem_shape_key(jps[1])
    again = batch.stack_problems(
        [batch.unstack_pytree(stacked, b) for b in range(3)])
    for got, want in zip(batch._tensors(again), batch._tensors(stacked)):
        assert torch.equal(got, want)


def test_stack_problems_rejects_mixed_shapes():
    _, a, _ = _dense_fleet(1, n=16)
    _, b, _ = _dense_fleet(1, n=24)
    with pytest.raises(ValueError, match="one shape signature"):
        batch.stack_problems(a + b)
    _, sp, _ = _sparse_fleet(1)
    _, dense, _ = _dense_fleet(1, n=64)
    with pytest.raises(ValueError, match="one shape signature"):
        batch.stack_problems(sp + dense)
    # a static field that differs cannot stack either
    with pytest.raises(ValueError, match="static field"):
        batch.stack_pytrees([sp[0], sp[0].__class__(
            **{**sp[0].__dict__, "max_degree": 40})])


def test_stack_empty_raises():
    with pytest.raises(ValueError):
        batch.stack_pytrees([])
    with pytest.raises(ValueError):
        batch.stack_problems([])


def test_unstack_inverts_stack_of_results():
    results = [RefineResult(torch.arange(5, dtype=torch.int32) + i,
                            torch.rand(3), torch.tensor(i), torch.tensor(2),
                            torch.tensor(True), torch.tensor(0.5))
               for i in range(4)]
    stacked = batch.stack_pytrees(results)
    assert type(stacked) is RefineResult
    assert stacked.assignment.shape == (4, 5)
    for i in range(4):
        _assert_element(results[i], stacked, i, "unstack")


def test_shard_across_devices_is_a_noop_on_one_device():
    _, ports, _ = _dense_fleet(2)
    stacked = batch.stack_problems(ports)
    assert batch.shard_across_devices(stacked) is stacked
    assert batch.shard_across_devices(
        stacked, [torch.device("cpu")]) is stacked
    with pytest.raises(NotImplementedError, match="distributed"):
        batch.shard_across_devices(stacked, [torch.device("cpu")] * 2)


# ---------------------------------------------------------------------------
# batched == looped, bitwise, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [None, "scalar", "per-node"])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_refine_batched_bitwise(rep, framework, theta):
    _, ports, r0s = _fleet(rep, 4, seed0=20)
    n = ports[0].num_nodes
    th, ths = _theta(theta, 4, n)
    res_b = batch.refine_batched(batch.stack_problems(ports),
                                 np.stack(r0s), framework, max_turns=2000,
                                 theta=th)
    for b in range(4):
        res_l = refine(ports[b], r0s[b], framework, max_turns=2000,
                       theta=ths[b])
        _assert_element(res_l, res_b, b, f"refine[{rep},{framework}]")
    assert bool(res_b.converged.all())
    # the elements converge on different turns, so masking was exercised
    assert len(set(res_b.num_turns.tolist())) > 1


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_refine_batched_verify_every_bitwise(rep):
    """``verify_every`` rebuilds only the still-active elements: the
    elements stop at different boundaries, as their looped runs do."""
    _, ports, r0s = _fleet(rep, 4, seed0=30)
    res_b = batch.refine_batched(batch.stack_problems(ports),
                                 np.stack(r0s), "c", max_turns=2000,
                                 verify_every=8)
    for b in range(4):
        res_l = refine(ports[b], r0s[b], "c", max_turns=2000,
                       verify_every=8)
        _assert_element(res_l, res_b, b, f"verify_every[{rep}]")
    assert len(set((res_b.num_turns // 8).tolist())) > 1


def test_refine_batched_default_is_kernel3_adapter():
    """The default reduction is the batched adapter (kernel 3's twin on
    the CPU); passing it explicitly, or its twin, changes nothing, and a
    CPU run launches no kernel."""
    _, ports, r0s = _dense_fleet(3, seed0=40)
    stacked = batch.stack_problems(ports)
    D.reset_launches()
    default = batch.refine_batched(stacked, np.stack(r0s), "ct")
    explicit = batch.refine_batched(
        stacked, np.stack(r0s), "ct",
        dissat_fn=ops.make_aggregate_dissat_fn_batched())
    for b in range(3):
        _assert_element(batch.unstack_pytree(default, b), explicit, b,
                        "explicit")
    assert all(v == 0 for v in D.launches.values())


@pytest.mark.parametrize("verify_every", [0, 16])
@pytest.mark.parametrize("theta", [False, True])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_refine_traced_batched_bitwise(rep, framework, theta, verify_every):
    _, ports, r0s = _fleet(rep, 4, seed0=50)
    th, ths = _theta("per-node" if theta else None, 4, ports[0].num_nodes)
    out_b = batch.refine_traced_batched(batch.stack_problems(ports),
                                        np.stack(r0s), framework,
                                        max_turns=64, theta=th,
                                        verify_every=verify_every)
    for b in range(4):
        out_l = refine_traced(ports[b], r0s[b], framework, max_turns=64,
                              theta=ths[b], verify_every=verify_every)
        _assert_element(out_l, out_b, b, f"traced[{rep},{framework}]")
    assert out_b[1].moved.shape == (4, 64)


def test_recompute_path_runs_element_by_element():
    _, ports, r0s = _dense_fleet(3, seed0=60)
    stacked = batch.stack_problems(ports)
    res_b = batch.refine_batched(stacked, np.stack(r0s), "ct",
                                 incremental=False)
    tr_b = batch.refine_traced_batched(stacked, np.stack(r0s), "ct",
                                       max_turns=32, incremental=False)
    for b in range(3):
        _assert_element(refine(ports[b], r0s[b], "ct", incremental=False),
                        res_b, b, "recompute")
        _assert_element(refine_traced(ports[b], r0s[b], "ct", max_turns=32,
                                      incremental=False), tr_b, b,
                        "traced recompute")


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_refine_simultaneous_batched_bitwise(rep, framework):
    _, ports, r0s = _fleet(rep, 3, seed0=70)
    out_b = batch.refine_simultaneous_batched(
        batch.stack_problems(ports), np.stack(r0s), framework,
        max_sweeps=32, theta=0.5)
    for b in range(3):
        out_l = refine_simultaneous(ports[b], r0s[b], framework,
                                    max_sweeps=32, theta=0.5)
        _assert_element(out_l, out_b, b, f"simultaneous[{rep}]")


@pytest.mark.parametrize("mode", [dict(moves_per_machine=2),
                                  dict(moves_per_machine=None)])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_refine_sweeps_batched_bitwise(rep, mode):
    """Probabilistic fleets == looped per element, coins included: each
    element draws from its own generator."""
    _, ports, r0s = _fleet(rep, 3, seed0=80)
    cfg = dict(max_sweeps=48, move_prob=0.5, epsilon=1e-3, **mode)
    gens = [torch.Generator().manual_seed(7 + b) for b in range(3)]
    out_b = batch.refine_sweeps_batched(batch.stack_problems(ports),
                                        np.stack(r0s), "c", generators=gens,
                                        **cfg)
    for b in range(3):
        out_l = refine_sweeps(ports[b], r0s[b], "c",
                              generator=torch.Generator().manual_seed(7 + b),
                              **cfg)
        _assert_element(out_l, out_b, b, f"sweeps[{rep}]")
    assert bool((out_b[0].num_moves > 0).all())


def test_refine_sweeps_batched_requires_generators():
    _, ports, r0s = _dense_fleet(2, seed0=80)
    stacked = batch.stack_problems(ports)
    with pytest.raises(ValueError, match="generators"):
        batch.refine_sweeps_batched(stacked, np.stack(r0s), "c",
                                    move_prob=0.5)
    with pytest.raises(ValueError, match="generators"):
        batch.refine_sweeps_batched(stacked, np.stack(r0s), "c",
                                    move_prob=0.5,
                                    generators=[torch.Generator()])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _j_stack(jps, r0s):
    return jbatch.stack_problems(jps), jnp.asarray(np.stack(r0s))


@pytest.mark.parametrize("framework,rep,theta", [
    ("c", "dense", None), ("ct", "dense", None), ("c", "dense", 0.5),
    ("ct", "dense", 0.5), ("c", "sparse", None), ("ct", "sparse", 0.5)])
def test_refine_batched_matches_reference_kernel_path(framework, rep,
                                                      theta):
    jps, ports, r0s = _fleet(rep, 4, seed0=90)
    jst, jr0 = _j_stack(jps, r0s)
    want = jbatch.refine_batched(
        jst, jr0, framework, max_turns=2000, theta=theta,
        dissat_fn=jops.make_aggregate_dissat_fn(interpret=True))
    got = batch.refine_batched(batch.stack_problems(ports), np.stack(r0s),
                               framework, max_turns=2000, theta=theta)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.num_moves.numpy(),
                                  np.asarray(want.num_moves))
    np.testing.assert_array_equal(got.num_turns.numpy(),
                                  np.asarray(want.num_turns))
    assert bool(got.converged.all()) and bool(np.asarray(want.converged)
                                              .all())
    np.testing.assert_allclose(got.loads.numpy(), np.asarray(want.loads),
                               rtol=1e-5)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_refine_traced_batched_matches_reference(framework):
    """Traced moves equal the reference's: every turn on ct; on c up to
    the reference's first source == dest move (caveat 1: its jnp
    reduction's current and best may differ by one ULP there).  Gains
    and carried potentials within 1e-3 relative (the reference's
    budget)."""
    jps, ports, r0s = _dense_fleet(4, seed0=100)
    jst, jr0 = _j_stack(jps, r0s)
    want_res, want = jbatch.refine_traced_batched(jst, jr0, framework,
                                                  max_turns=96)
    got_res, got = batch.refine_traced_batched(
        batch.stack_problems(ports), np.stack(r0s), framework, max_turns=96)
    for b in range(4):
        src, dst = np.asarray(want.source)[b], np.asarray(want.dest)[b]
        cyc = np.nonzero((src == dst) & (src >= 0))[0]
        upto = int(cyc[0]) if cyc.size else 96
        if framework == "ct":
            assert upto == 96
        for field in ("moved", "node", "source", "dest", "active"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy()[b, :upto],
                np.asarray(getattr(want, field))[b, :upto])
        for field in ("gain", "c0", "ct0"):
            np.testing.assert_allclose(
                getattr(got, field).numpy()[b, :upto],
                np.asarray(getattr(want, field))[b, :upto], rtol=1e-3,
                atol=1e-2)
    if framework == "ct":
        np.testing.assert_array_equal(got_res.assignment.numpy(),
                                      np.asarray(want_res.assignment))
        np.testing.assert_array_equal(got_res.num_moves.numpy(),
                                      np.asarray(want_res.num_moves))


# ---------------------------------------------------------------------------
# kernel 3's twin
# ---------------------------------------------------------------------------

def _batched_operands(bsz, n, k, seed):
    rng = np.random.default_rng(seed)
    agg = rng.uniform(0, 50, (bsz, n, k)).astype(np.float32)
    r = rng.integers(0, k, (bsz, n)).astype(np.int32)
    b = rng.uniform(0.1, 10, (bsz, n)).astype(np.float32)
    speeds = rng.uniform(0.2, 2.0, (bsz, k)).astype(np.float32)
    speeds /= speeds.sum(axis=1, keepdims=True)
    loads = np.zeros((bsz, k), np.float32)
    for e in range(bsz):
        np.add.at(loads[e], r[e], b[e])
    mu = rng.choice([4.0, 8.0, 16.0], bsz).astype(np.float32)
    theta = rng.uniform(0, 30, (bsz, n)).astype(np.float32)
    return agg, r, b, loads, speeds, mu, theta


@pytest.mark.parametrize("theta", [False, True])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("bsz,n,k", [(3, 130, 5), (2, 300, 16), (4, 7, 2)])
def test_batched_twin_matches_pallas(bsz, n, k, framework, theta):
    agg, r, b, loads, speeds, mu, th = _batched_operands(bsz, n, k,
                                                         seed=n + k)
    th = th if theta else None
    want = dissatisfaction_from_aggregate_batched_pallas(
        jnp.asarray(agg), jnp.asarray(r), jnp.asarray(b), jnp.asarray(loads),
        jnp.asarray(speeds), jnp.asarray(mu), framework,
        theta=None if th is None else jnp.asarray(th), interpret=True)
    t = torch.from_numpy
    got = D.dissatisfaction_from_aggregate_batched_plain(
        t(agg), t(r), t(b), t(loads), t(speeds), t(mu), framework,
        theta=None if th is None else t(th))
    got_d, got_b = (x.numpy() for x in got)
    want_d, want_b = (np.asarray(x) for x in want)
    assert got_b.dtype == np.int32
    np.testing.assert_array_equal(got_b, want_b)
    assert (got_d[want_d == 0] == 0).all()
    np.testing.assert_allclose(got_d, want_d, rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_batched_twin_is_kernel1_twin_per_element(framework):
    agg, r, b, loads, speeds, mu, th = _batched_operands(4, 301, 8, seed=3)
    t = torch.from_numpy
    total = torch.stack([torch.sum(x) for x in t(b)])
    for theta in (None, t(th)):
        got = ops.make_aggregate_dissat_fn_batched()(
            t(agg), t(r), t(b), t(loads), t(speeds), t(mu), framework,
            total, theta)
        for e in range(4):
            want = D.dissatisfaction_from_aggregate_plain(
                t(agg)[e], t(r)[e], t(b)[e], t(loads)[e], t(speeds)[e],
                t(mu)[e], framework,
                theta=None if theta is None else theta[e])
            assert torch.equal(got[0][e], want[0])
            assert torch.equal(got[1][e], want[1])


def test_batched_kernel_wrapper_refuses_cpu_tensors():
    agg, r, b, loads, speeds, mu, _ = _batched_operands(2, 10, 3, seed=4)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        D.dissatisfaction_from_aggregate_batched_cuda(
            t(agg), t(r), t(b), t(loads), t(speeds), t(mu), "c")
