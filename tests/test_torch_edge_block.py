"""The port's edge-block kernels (kernels 4 and 5) against the JAX
reference's Pallas kernels, on the CPU.

The reference kernels run in interpret mode, as ``tests/test_sparse.py``
runs them; the port's wrappers take their plain twins here (the tensors
lie on the CPU).  Tolerances: ``best`` machines, sweep picks and dests
exactly; the dissatisfaction within the reference's own rtol 1e-3,
atol 1e-2 (``tests/test_sparse.py``: the reference's MXU one-hot product
and assembly round some products differently).  Within the port the twins
are held bitwise: kernel 4's twin equals kernel 1's twin on the sparse
aggregate, and kernel 5's twin equals the first-maximum election from
kernel 4's output.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.edge_block import (build_edge_tile_layout,
                                      dissatisfaction_from_edges_pallas,
                                      sweep_candidates_from_edges_pallas)
from repro_torch.core import costs
from repro_torch.core.problem import machine_loads
from repro_torch.kernels import dissatisfaction as D
from repro_torch.kernels import edge_block as E
from repro_torch.kernels import ops

from test_torch_sparse import sparse_pair

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-2


def _operands(sp, r0, theta):
    r = torch.from_numpy(r0)
    b = sp.node_weights
    loads = machine_loads(b, r, sp.num_machines)
    th = None if theta is None else torch.full((sp.num_nodes,), theta)
    return r, b, loads, th


def _reference(fn, jp, r0, loads, framework, theta):
    return fn(build_edge_tile_layout(jp), jnp.asarray(r0), jp.node_weights,
              jnp.asarray(loads.numpy()), jp.speeds, jp.mu, framework,
              theta=None if theta is None else jnp.asarray(theta.numpy()),
              total_weight=jnp.sum(jp.node_weights), interpret=True)


CASES = [(n, fw, th) for n in (150, 1003) for fw in ("c", "ct")
         for th in (None, 0.5)]


@pytest.mark.parametrize("n,framework,theta", CASES)
def test_edge_dissat_twin_matches_pallas(n, framework, theta):
    """Kernel 4's twin vs ``dissatisfaction_from_edges_pallas``."""
    jp, sp, r0 = sparse_pair(n, 8, seed=n)
    r, b, loads, th = _operands(sp, r0, theta)
    want_d, want_b = _reference(dissatisfaction_from_edges_pallas, jp, r0,
                                loads, framework, th)
    got_d, got_b = E.dissatisfaction_from_edges_plain(
        sp, r, b, loads, sp.speeds, sp.mu, framework, theta=th)
    assert got_d.dtype == torch.float32 and got_b.dtype == torch.int32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,framework,theta", CASES)
def test_edge_dissat_twin_bitwise_equals_kernel1_twin(n, framework, theta):
    """Kernel 4's twin == kernel 1's twin on the sparse aggregate, bit for
    bit: the same slot order and the same epilogue."""
    _, sp, r0 = sparse_pair(n, 8, seed=n + 1)
    r, b, loads, th = _operands(sp, r0, theta)
    agg = costs.adjacency_aggregate_sparse(sp, r)
    want = D.dissatisfaction_from_aggregate_plain(
        agg, r, b, loads, sp.speeds, sp.mu, framework, theta=th)
    got = E.dissatisfaction_from_edges_plain(sp, r, b, loads, sp.speeds,
                                             sp.mu, framework, theta=th)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,framework,theta", CASES)
def test_sweep_twin_matches_pallas(n, framework, theta):
    """Kernel 5's twin vs ``sweep_candidates_from_edges_pallas``: picks
    and dests exactly, gains within the dissatisfaction tolerance."""
    jp, sp, r0 = sparse_pair(n, 8, seed=n + 2)
    r, b, loads, th = _operands(sp, r0, theta)
    want = _reference(sweep_candidates_from_edges_pallas, jp, r0, loads,
                      framework, th)
    got = E.sweep_candidates_from_edges_plain(sp, r, b, loads, sp.speeds,
                                              sp.mu, framework, theta=th)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


def test_sweep_twin_is_the_first_max_election():
    """Kernel 5's twin == the first-maximum election from kernel 4's
    output; a machine owning nothing gets NEG_BIG, node 0 and node 0's
    best machine, as the reference's kernel leaves it."""
    _, sp, r0 = sparse_pair(300, 8, seed=9)
    r0 = np.where(r0 == 5, 4, r0).astype(np.int32)     # machine 5 idle
    r, b, loads, _ = _operands(sp, r0, None)
    d, best = E.dissatisfaction_from_edges_plain(sp, r, b, loads, sp.speeds,
                                                 sp.mu, "c")
    gains, picks, dests = E.sweep_candidates_from_edges_plain(
        sp, r, b, loads, sp.speeds, sp.mu, "c")
    for m in range(8):
        owned = np.flatnonzero(r0 == m)
        if owned.size == 0:
            assert float(gains[m]) == np.float32(E.NEG_BIG)
            assert int(picks[m]) == 0 and int(dests[m]) == int(best[0])
            continue
        top = d.numpy()[owned].max()
        first = owned[np.flatnonzero(d.numpy()[owned] == top)[0]]
        assert float(gains[m]) == top
        assert int(picks[m]) == first and int(dests[m]) == int(best[first])


def test_ops_adapters_take_the_twins_on_the_cpu():
    """``make_edge_dissat_fn`` / ``make_edge_sweep_fn`` follow the
    9-argument convention, ignore the aggregate, and run the twins for
    CPU tensors without launching anything."""
    _, sp, r0 = sparse_pair(120, 4, seed=3)
    r, b, loads, th = _operands(sp, r0, 0.25)
    E.reset_launches()
    args = (torch.full((120, 4), float("nan")), r, b, loads, sp.speeds,
            sp.mu, "ct", torch.sum(b), th)
    d, best = ops.make_edge_dissat_fn(sp)(*args)
    want = E.dissatisfaction_from_edges_plain(sp, r, b, loads, sp.speeds,
                                              sp.mu, "ct", theta=th)
    assert torch.equal(d, want[0]) and torch.equal(best, want[1])
    g, p, dst = ops.make_edge_sweep_fn(sp)(*args)
    assert torch.equal(p, E.elect(d, best, r, 4)[1])
    assert E.launches == {"dissat_from_edges": 0,
                          "sweep_candidates_from_edges": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    _, sp, r0 = sparse_pair(50, 4, seed=1)
    r, b, loads, _ = _operands(sp, r0, None)
    for fn in (E.dissatisfaction_from_edges_cuda,
               E.sweep_candidates_from_edges_cuda):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            fn(sp, r, b, loads, sp.speeds, sp.mu, "c")
