"""Kernels 1 and 3's launch path and instances, on the CPU.

The CUDA kernels of ``csrc/dissatisfaction.cu`` do not build here; what
surrounds them does run here: the wrappers' shared operand checks (on CPU
tensors against an explicit device), the device-scalar pass-through, the
twins at every K the kernel source specialises and on its runtime-K
instance (kernel 3's twin at B = 1 bitwise kernel 1's; kernel 1's twin
against the reference's Pallas kernel in interpret mode, within the
budget of ``tests/test_torch_kernels.py``), and the source's list of
template instances.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.dissatisfaction import \
    dissatisfaction_from_aggregate_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import dissatisfaction as D

CPU = torch.device("cpu")
# every instance: the specialised K, and K that take the runtime-K one
ALL_K = sorted(set(D.SPECIALISED_K) | {1, 3, 17, 100})
SOURCE = (_build.CSRC / "dissatisfaction.cu").read_text()


def _operands(bsz, n, k, seed):
    """Kernel 3's operands as CPU tensors, (B, n, K)."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    agg = t(rng.uniform(0, 50, (bsz, n, k)).astype(np.float32))
    r = t(rng.integers(0, k, (bsz, n)).astype(np.int32))
    b = t(rng.uniform(0.1, 10, (bsz, n)).astype(np.float32))
    sp = rng.uniform(0.2, 2.0, (bsz, k))
    speeds = t((sp / sp.sum(axis=1, keepdims=True)).astype(np.float32))
    loads = t(rng.uniform(0, 5 * n / k, (bsz, k)).astype(np.float32))
    mu = t(rng.choice([4.0, 8.0, 16.0], bsz).astype(np.float32))
    theta = t(rng.uniform(0, 30, (bsz, n)).astype(np.float32))
    return agg, r, b, loads, speeds, mu, theta


def _kernel1_operands(n=40, k=4, seed=0):
    agg, r, b, loads, speeds, mu, theta = _operands(1, n, k, seed)
    return agg[0], r[0], b[0], loads[0], speeds[0], mu[0], theta[0]


# ---------------------------------------------------------------------------
# the shared operand checks
# ---------------------------------------------------------------------------

def _bad(kind, name, t):
    if kind == "dtype":
        return t.double() if t.dtype == torch.float32 else t.long()
    if kind == "shape":
        return (t[..., :-1, :] if name == "aggregate"
                else t[..., :-1]).contiguous()
    return torch.stack([t, t], dim=-1)[..., 0]       # not contiguous


_OPERANDS = ("aggregate", "row_assignment", "node_weights", "loads",
             "speeds", "theta")
_WHY = {"dtype": "must be torch", "shape": "must have shape",
        "contiguity": "must be contiguous"}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["dtype", "shape", "contiguity"])
@pytest.mark.parametrize("name", _OPERANDS)
def test_checks_refuse_each_operand(name, kind, batched):
    """Each operand of kernels 1 and 3 with the wrong dtype, shape or
    layout is refused, named, before anything else happens."""
    ops = dict(zip(("aggregate", "row_assignment", "node_weights", "loads",
                    "speeds", "mu", "theta"),
                   _operands(2, 40, 4, seed=1) if batched
                   else _kernel1_operands(seed=1)))
    ops[name] = _bad(kind, name, ops[name])
    # the aggregate's shape sets rows and K: with a row fewer, the first
    # operand found at fault is the assignment
    blamed = ("row_assignment" if (name, kind) == ("aggregate", "shape")
              else name)
    mu = ops.pop("mu")
    extra = dict(mu=mu, total_weight=torch.sum(ops["node_weights"], -1)) \
        if batched else {}
    with pytest.raises(ValueError, match=f"{blamed} {_WHY[kind]}"):
        D.check_dissat_operands(**ops, **extra, device=CPU, batched=batched)


@pytest.mark.parametrize("name", ["mu", "total_weight"])
@pytest.mark.parametrize("kind", ["dtype", "shape", "contiguity"])
def test_checks_refuse_kernel3_scalars(name, kind):
    agg, r, b, loads, speeds, mu, _ = _operands(3, 20, 4, seed=2)
    scalars = {"mu": mu, "total_weight": torch.sum(b, 1)}
    t = scalars[name]
    scalars[name] = (t.double() if kind == "dtype" else t[:2] if
                     kind == "shape" else torch.stack([t, t], 1)[:, 0])
    with pytest.raises(ValueError, match=f"{name} {_WHY[kind]}"):
        D.check_dissat_operands(agg, r, b, loads, speeds, None, **scalars,
                                device=CPU, batched=True)


@pytest.mark.parametrize("k", [0, D.MAX_K + 1])
@pytest.mark.parametrize("batched", [False, True])
def test_checks_refuse_k_out_of_range(k, batched):
    bsz = 2
    lead = (bsz,) if batched else ()
    agg = torch.zeros(lead + (10, k))
    r = torch.zeros(lead + (10,), dtype=torch.int32)
    b = torch.ones(lead + (10,))
    w = torch.ones(lead + (k,))
    mu = torch.full(lead, 8.0)
    with pytest.raises(ValueError, match=f"1 <= K <= {D.MAX_K}; got K={k}"):
        D.check_dissat_operands(agg, r, b, w, w, None, mu, None, device=CPU,
                                batched=batched)


@pytest.mark.parametrize("bsz", [0, D.MAX_BATCH + 1])
def test_checks_refuse_b_out_of_range(bsz):
    # no storage is needed to be refused: expanded views of one element
    agg = torch.zeros(1, 1, 3).expand(bsz, 1, 3)
    with pytest.raises(ValueError, match=f"1 <= B <= {D.MAX_BATCH}; got "
                                         f"B={bsz}"):
        D.check_dissat_operands(agg, None, None, None, None, None,
                                device=CPU, batched=True)


@pytest.mark.parametrize("batched", [False, True])
def test_checks_refuse_a_wrong_rank(batched):
    agg = torch.zeros(2, 3, 4, 5) if batched else torch.zeros(3, 4, 5)
    with pytest.raises(ValueError, match="aggregate must be"):
        D.check_dissat_operands(agg, None, None, None, None, None,
                                device=CPU, batched=batched)


def test_checks_refuse_tensors_on_another_device():
    """CPU operands checked against a CUDA device are refused by name."""
    ops = _kernel1_operands(seed=3)
    with pytest.raises(ValueError, match="aggregate must be a tensor on "
                                         "cuda"):
        D.check_dissat_operands(*ops[:5], None, device=torch.device("cuda"))
    with pytest.raises(ValueError, match="loads must be a tensor on cpu"):
        D.check_dissat_operands(*ops[:3], ops[3].numpy(), ops[4], None,
                                device=CPU)


@pytest.mark.parametrize("batched", [False, True])
def test_checks_return_the_launch_shape(batched):
    if batched:
        agg, r, b, loads, speeds, mu, theta = _operands(3, 50, 8, seed=4)
        got = D.check_dissat_operands(agg, r, b, loads, speeds, theta, mu,
                                      torch.sum(b, 1), device=CPU,
                                      batched=True)
        assert got == (3, 50, 8)
        # total_weight may be left to the wrapper's default
        assert D.check_dissat_operands(agg, r, b, loads, speeds, None, mu,
                                       device=CPU, batched=True) == got
    else:
        ops = _kernel1_operands(n=50, k=8, seed=4)
        assert D.check_dissat_operands(*ops[:5], ops[6],
                                       device=CPU) == (1, 50, 8)


def test_check_keeps_its_messages():
    """The lean ``_check`` that every wrapper shares raises what it raised
    before, in the same order: device, dtype, shape, layout."""
    t = torch.zeros(4, 3)
    assert D._check("x", t, torch.float32, (4, 3), CPU) is None
    cases = [((np.zeros(3), torch.float32, (3,), CPU), "x must be a tensor "
              "on cpu"),
             ((t, torch.float32, (4, 3), torch.device("cuda")),
              "x must be a tensor on cuda"),
             ((t, torch.int32, (4, 3), CPU), "x must be torch.int32; got "
              "torch.float32"),
             ((t, torch.float32, (3, 4), CPU), r"x must have shape \(3, 4\); "
              r"got \(4, 3\)"),
             ((t.T, torch.float32, (3, 4), CPU), "x must be contiguous"),
             ((t.T, torch.int32, (4, 3), CPU), "x must be torch.int32")]
    for args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            D._check("x", *args)


# ---------------------------------------------------------------------------
# device scalars
# ---------------------------------------------------------------------------

def test_scalar_passes_what_needs_no_work():
    mu = torch.tensor(8.0)
    assert D._scalar(mu, CPU) is mu
    for other in (8.0, 8, torch.tensor(8.0, dtype=torch.float64),
                  torch.tensor([8.0])):
        got = D._scalar(other, CPU)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == 8.0


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_mu_as_a_float_or_a_tensor_gives_the_same_twin(framework):
    agg, r, b, loads, speeds, _, theta = _kernel1_operands(n=77, k=5, seed=5)
    for th in (None, theta):
        as_float = D.dissatisfaction_from_aggregate_plain(
            agg, r, b, loads, speeds, 8.0, framework, theta=th)
        as_tensor = D.dissatisfaction_from_aggregate_plain(
            agg, r, b, loads, speeds, torch.tensor(8.0), framework,
            theta=th)
        converted = D.dissatisfaction_from_aggregate_plain(
            agg, r, b, loads, speeds, D._scalar(8.0, CPU), framework,
            theta=th)
        for got in (as_tensor, converted):
            assert torch.equal(got[0], as_float[0])
            assert torch.equal(got[1], as_float[1])


# ---------------------------------------------------------------------------
# every instance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", ALL_K)
def test_kernel3_twin_at_b1_is_kernel1_twin(k):
    agg, r, b, loads, speeds, mu, theta = _operands(1, 129, k, seed=k)
    for framework in ("c", "ct"):
        for th in (None, theta):
            got = D.dissatisfaction_from_aggregate_batched_plain(
                agg, r, b, loads, speeds, mu, framework, theta=th)
            want = D.dissatisfaction_from_aggregate_plain(
                agg[0], r[0], b[0], loads[0], speeds[0], mu[0], framework,
                theta=None if th is None else th[0])
            assert torch.equal(got[0][0], want[0])
            assert torch.equal(got[1][0], want[1])


@pytest.mark.parametrize("k", ALL_K)
def test_kernel1_twin_matches_pallas_at_every_instance(k):
    """Kernel 1's twin against ``dissatisfaction_from_aggregate_pallas``
    (interpret mode) at every K the kernel has an instance for: best
    equal, dissat within rtol 2e-4, atol 2e-2 (test_torch_kernels.py's
    budget: the reference's XLA program rounds some products
    differently)."""
    agg, r, b, loads, speeds, mu, theta = _kernel1_operands(n=37, k=k,
                                                            seed=100 + k)
    want = dissatisfaction_from_aggregate_pallas(
        jnp.asarray(agg.numpy()), jnp.asarray(r.numpy()),
        jnp.asarray(b.numpy()), jnp.asarray(loads.numpy()),
        jnp.asarray(speeds.numpy()), float(mu), "c",
        theta=jnp.asarray(theta.numpy()), interpret=True)
    got = D.dissatisfaction_from_aggregate_plain(agg, r, b, loads, speeds,
                                                 float(mu), "c", theta=theta)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=2e-2)


def test_specialised_k_matches_the_kernel_source():
    """SPECIALISED_K is the list of launch_dissat's template cases; every
    other K falls to the runtime-K instance, <0>."""
    cases = re.findall(r"case (\d+): return launch_rows<(\d+)>", SOURCE)
    assert [int(a) for a, _ in cases] == list(D.SPECIALISED_K)
    assert all(a == b for a, b in cases)
    assert "default: return launch_rows<0>" in SOURCE

