"""The port's kernel layer against the JAX reference's Pallas kernels.

The reference kernels run in interpret mode on the CPU, as
``tests/test_kernels.py`` runs them; the port's wrappers run their plain
PyTorch twins here (the tensors lie on the CPU).  Inputs are made with
numpy from a seed and handed to both as arrays.

Tolerances: ``best`` machines must match exactly, and the dissatisfaction
must be exactly 0 wherever the reference's is.  Float values are held to
``rtol=2e-4, atol=2e-2``, the budget the reference holds its own kernels
to against its jnp oracle: the reference's XLA program and the twin's
separate ops round some products differently, a few ULP of costs of up to
~1e5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import costs as jcosts
from repro.kernels import ref as jref
from repro.kernels.dissatisfaction import (
    cost_matrix_pallas, dissatisfaction_from_aggregate_pallas)
from repro_torch.kernels import dissatisfaction as D
from repro_torch.kernels import ops, ref

from test_torch_gpu import _arrays

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _ref_aggregate(adj, r, k):
    return np.asarray(jcosts.adjacency_aggregate(jnp.asarray(adj),
                                                 jnp.asarray(r), k))


def _assert_dissat(got, want):
    got_d, got_b = (x.numpy() for x in got)
    want_d, want_b = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got_b, want_b)
    assert (got_d[want_d == 0] == 0).all()
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("theta", [False, True])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("k", [2, 5, 16])
@pytest.mark.parametrize("n", [7, 130, 300])
def test_dissat_twin_matches_pallas(n, k, framework, theta):
    """Kernel 1's twin vs ``dissatisfaction_from_aggregate_pallas`` on the
    same aggregate, ragged N included."""
    adj, r, b, loads, speeds, th = _arrays(n, k, seed=n * 13 + k)
    agg = _ref_aggregate(adj, r, k)
    th = th if theta else None
    want = dissatisfaction_from_aggregate_pallas(
        jnp.asarray(agg), jnp.asarray(r), jnp.asarray(b), jnp.asarray(loads),
        jnp.asarray(speeds), 8.0, framework,
        theta=None if th is None else jnp.asarray(th), interpret=True)
    got = ops.dissatisfaction_from_aggregate(
        _t(agg), _t(r), _t(b), _t(loads), _t(speeds), torch.tensor(8.0),
        torch.sum(_t(b)), framework, theta=None if th is None else _t(th))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_dissat(got, want)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_dissat_twin_row_block(framework):
    """Row blocks with the global ``total_weight`` reproduce the matching
    rows of the reference kernel's full reduction."""
    adj, r, b, loads, speeds, _ = _arrays(90, 5, seed=33)
    agg = _ref_aggregate(adj, r, 5)
    total_b = float(np.sum(b, dtype=np.float32))
    want = dissatisfaction_from_aggregate_pallas(
        jnp.asarray(agg), jnp.asarray(r), jnp.asarray(b), jnp.asarray(loads),
        jnp.asarray(speeds), 4.0, framework, interpret=True)
    lo, hi = 30, 61
    got = D.dissatisfaction_from_aggregate_plain(
        _t(agg[lo:hi]), _t(r[lo:hi]), _t(b[lo:hi]), _t(loads), _t(speeds),
        torch.tensor(4.0), framework, total_weight=torch.tensor(total_b))
    _assert_dissat(got, (np.asarray(want[0])[lo:hi],
                         np.asarray(want[1])[lo:hi]))


def test_dissat_twin_theta_none_equals_zero():
    """``theta=None`` and an explicit zero theta give bitwise the same."""
    adj, r, b, loads, speeds, _ = _arrays(70, 5, seed=51)
    agg = _t(_ref_aggregate(adj, r, 5))
    args = (agg, _t(r), _t(b), _t(loads), _t(speeds), torch.tensor(8.0))
    none = D.dissatisfaction_from_aggregate_plain(*args, "ct")
    zero = D.dissatisfaction_from_aggregate_plain(*args, "ct",
                                                  theta=torch.zeros(70))
    assert torch.equal(none[0], zero[0]) and torch.equal(none[1], zero[1])


def test_dissat_twin_lowest_index_tie_break():
    """Exact ties break toward the lowest machine (DESIGN.md §7)."""
    agg = torch.zeros((4, 3))
    r = torch.tensor([2, 1, 0, 2], dtype=torch.int32)
    b = torch.zeros(4)
    d, best = D.dissatisfaction_from_aggregate_plain(
        agg, r, b, torch.ones(3), torch.ones(3) / 3, torch.tensor(1.0), "c")
    assert best.tolist() == [0, 0, 0, 0]
    assert d.tolist() == [0.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("k", [2, 5, 16])
@pytest.mark.parametrize("n", [7, 130, 300])
def test_cost_matrix_twin_matches_pallas(n, k, framework):
    """Kernel 2's twin vs ``cost_matrix_pallas`` on the square problem."""
    adj, r, b, loads, speeds, _ = _arrays(n, k, seed=n * 31 + k)
    want = cost_matrix_pallas(jnp.asarray(adj), jnp.asarray(r),
                              jnp.asarray(b), jnp.asarray(loads),
                              jnp.asarray(speeds), 8.0, framework,
                              interpret=True)
    got = ops.cost_matrix(_t(adj), _t(r), _t(b), _t(loads), _t(speeds),
                          torch.tensor(8.0), framework)
    assert got.shape == (n, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_cost_matrix_twin_row_block(framework):
    """A rectangular (rows, N) block with its own row assignment and the
    global B matches the reference kernel's row-block call."""
    adj, r, b, loads, speeds, _ = _arrays(160, 5, seed=71)
    lo, hi = 40, 117
    total_b = float(np.sum(b, dtype=np.float32))
    want = cost_matrix_pallas(
        jnp.asarray(adj[lo:hi]), jnp.asarray(r), jnp.asarray(b[lo:hi]),
        jnp.asarray(loads), jnp.asarray(speeds), 8.0, framework,
        row_assignment=jnp.asarray(r[lo:hi]),
        total_weight=jnp.asarray(total_b), interpret=True)
    got = ops.cost_matrix(_t(adj[lo:hi]), _t(r), _t(b[lo:hi]), _t(loads),
                          _t(speeds), torch.tensor(8.0), framework,
                          row_assignment=_t(r[lo:hi]),
                          total_weight=torch.tensor(total_b))
    assert got.shape == (hi - lo, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_cost_matrix_reference_matches_jax_oracle(framework):
    """``ops.cost_matrix_reference`` (the port's oracle) vs the reference's
    ``cost_matrix_ref``."""
    adj, r, b, loads, speeds, _ = _arrays(96, 4, seed=9)
    want = jref.cost_matrix_ref(jnp.asarray(adj), jnp.asarray(r),
                                jnp.asarray(b), jnp.asarray(loads),
                                jnp.asarray(speeds), 2.0, framework)
    got = ops.cost_matrix_reference(_t(adj), _t(r), _t(b), _t(loads),
                                    _t(speeds), 2.0, framework)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        ref.cost_matrix_ref(_t(adj), _t(r), _t(b), _t(loads), _t(speeds),
                            2.0, framework).numpy(),
        got.numpy(), rtol=0, atol=0)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    """On CPU tensors the adapters run the plain twins; nothing counts as
    a kernel launch."""
    adj, r, b, loads, speeds, _ = _arrays(40, 3, seed=3)
    D.reset_launches()
    ops.cost_matrix(_t(adj), _t(r), _t(b), _t(loads), _t(speeds),
                    torch.tensor(8.0))
    fn = ops.make_aggregate_dissat_fn()
    fn(_t(_ref_aggregate(adj, r, 3)), _t(r), _t(b), _t(loads), _t(speeds),
       torch.tensor(8.0), "c", torch.sum(_t(b)), None)
    ops.make_aggregate_dissat_fn_batched()(
        _t(_ref_aggregate(adj, r, 3))[None], _t(r)[None], _t(b)[None],
        _t(loads)[None], _t(speeds)[None], torch.tensor([8.0]), "c",
        torch.sum(_t(b))[None], None)
    assert D.launches == {"dissat_from_aggregate": 0, "cost_matrix": 0,
                          "dissat_from_aggregate_batched": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch only on CUDA tensors; they never fall
    back to the twin."""
    adj, r, b, loads, speeds, _ = _arrays(20, 3, seed=4)
    agg = _t(_ref_aggregate(adj, r, 3))
    with pytest.raises(ValueError, match="CUDA"):
        D.dissatisfaction_from_aggregate_cuda(agg, _t(r), _t(b), _t(loads),
                                              _t(speeds), 8.0, "c")
    with pytest.raises(ValueError, match="CUDA"):
        D.cost_matrix_cuda(_t(adj), _t(r), _t(b), _t(loads), _t(speeds),
                           8.0, "c")
