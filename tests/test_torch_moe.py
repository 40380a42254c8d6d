"""The port's MoE block (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the smoke configs of
granite-moe-1b-a400m (4 experts, top-2, capacity 1.5) and
qwen3-moe-235b-a22b (8 experts, top-2, capacity 1.25), groups of 16
tokens.

Weights come from the reference's ``init_moe(PRNGKey(0), cfg)``; inputs
from ``numpy.random.default_rng``.  Every ``moe_impl`` (scatter, einsum,
dense) runs at ample capacity (8.0), at capacities that drop (0.5, 0.25),
dropless, and at token counts that are and are not a multiple of the
group size.  Exact: the routing ids, and the capacity buffers the experts
read (a kept (token, slot) pair copies its token's row into its
(group, expert, place), so equal buffers are equal keep masks and
places), hence the kept and dropped counts.  Within rtol = atol = 1e-4
(the reference's own tolerance between its impls, ``tests/test_models.py``):
the outputs and the three router statistics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
TOL = dict(rtol=1e-4, atol=1e-4)
# (impl, capacity_factor); "dropless" calls moe_block(dropless=True) at the
# config's capacity
CASES = [(impl, cap) for impl in ("scatter", "einsum")
         for cap in (8.0, 0.5, 0.25, "dropless")] + [("dense", None)]
# (B, S): T = 26 is a group of 16 and a padded one; T = 5 is one group of
# 5 (the group size is min(moe_group_size, T))
SHAPES = [(2, 13), (1, 5)]


def _setup(arch, **replace):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **replace)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **replace)
    jparams = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    return jcfg, jparams, tcfg, tparams


def _x(cfg, shape, seed):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _spy_buffers(monkeypatch, module):
    """Record every (G, E, C, d) buffer ``module._experts`` is given."""
    seen = []
    real = module._experts

    def spy(params, buf, dtype):
        seen.append(np.array(buf))
        return real(params, buf, dtype)

    monkeypatch.setattr(module, "_experts", spy)
    return seen


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"B{s[0]}S{s[1]}")
@pytest.mark.parametrize("impl,cap", CASES,
                         ids=[f"{i}-{c}" for i, c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, impl, cap, shape, monkeypatch):
    replace = {"moe_impl": impl}
    if isinstance(cap, float):
        replace["capacity_factor"] = cap
    jcfg, jparams, tcfg, tparams = _setup(arch, **replace)
    dropless = cap == "dropless"
    jx, tx = _x(tcfg, shape, seed=1)
    jbufs = _spy_buffers(monkeypatch, jmoe)
    tbufs = _spy_buffers(monkeypatch, tmoe)
    jy, jstats = jmoe.moe_block(jparams, jcfg, jx, dropless=dropless)
    ty, tstats = tmoe.moe_block(tparams, tcfg, tx, dropless=dropless)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    _close(ty, jy)
    for got, want in zip(tstats, jstats):
        _close(got, want)
    if impl == "dense":
        assert jbufs == [] and tbufs == []
        return
    (jbuf,), (tbuf,) = jbufs, tbufs
    np.testing.assert_array_equal(tbuf, jbuf)
    _, ids, _ = tmoe._route(tparams, tcfg, tx.reshape(-1, tcfg.d_model))
    plan = tmoe._dispatch(ids, tcfg, dropless=dropless)
    t = shape[0] * shape[1]
    kept = int(plan.keep.sum())
    assert kept == int(np.any(jbuf != 0, axis=-1).sum())
    dropped = t * tcfg.top_k - kept
    if cap in (8.0, "dropless"):
        assert dropped == 0
    elif cap == 0.25:
        assert dropped > 0
    assert plan.cap == (plan.sg if dropless else max(
        1, int(cap * plan.sg * tcfg.top_k / tcfg.num_experts)))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """Routing ids exactly, weights and statistics within 1e-4."""
    jcfg, jparams, tcfg, tparams = _setup(arch)
    jx, tx = _x(tcfg, (40,), seed=2)
    jw, jids, jstats = jmoe._route(jparams, jcfg, jx)
    tw, tids, tstats = tmoe._route(tparams, tcfg, tx)
    assert tids.tolist() == np.asarray(jids).tolist()
    _close(tw, jw)
    for got, want in zip(tstats, jstats):
        _close(got, want)
    assert abs(float(tstats.expert_load.sum()) - tcfg.top_k) < 1e-5
    coact = tstats.coactivation
    assert torch.equal(coact, coact.T)
    assert not bool(torch.diagonal(coact).any())


@pytest.mark.parametrize("arch", ARCHS)
def test_top_k_ties_break_toward_the_lowest_expert(arch):
    """Equal router probabilities pick the lowest expert ids first, as
    ``jax.lax.top_k``: a zero row ties every expert; experts 1 and 3 have
    equal router columns (dyadic values on {-1, 0, 1} inputs, so the
    logits are equal exactly)."""
    jcfg, _, tcfg, _ = _setup(arch)
    rng = np.random.default_rng(3)
    e, k = tcfg.num_experts, tcfg.top_k
    router = rng.integers(-8, 9, (tcfg.d_model, e)).astype(np.float32) / 8
    router[:, 3] = router[:, 1]
    x = rng.integers(-1, 2, (64, tcfg.d_model)).astype(np.float32)
    x[0] = 0.0
    _, jids, _ = jmoe._route({"router": jnp.asarray(router)}, jcfg,
                             jnp.asarray(x))
    _, tids, _ = tmoe._route({"router": torch.from_numpy(router)}, tcfg,
                             torch.from_numpy(x))
    assert tids.tolist() == np.asarray(jids).tolist()
    assert tids[0].tolist() == list(range(k))
    probs = torch.softmax(torch.from_numpy(x @ router), dim=-1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    rows = tids.tolist()
    assert not any(3 in r and 1 not in r for r in rows)
    assert all(r.index(1) < r.index(3) for r in rows if 3 in r)
    assert any(1 in r and 3 not in r for r in rows)      # ties at the cut


def test_init_moe_shapes_and_scales():
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("qwen3-moe-235b-a22b"), d_model=256,
        d_ff=128)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    params = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    want = {"router": ((d, e), d ** -0.5), "gate": ((e, d, f), d ** -0.5),
            "up": ((e, d, f), d ** -0.5), "down": ((e, f, d), f ** -0.5)}
    assert sorted(params) == sorted(want)
    for name, (shape, scale) in want.items():
        w = params[name]
        assert w.shape == shape and w.dtype == cfg.pdtype()
        assert abs(float(w.std()) / scale - 1.0) < 0.05, name
        assert abs(float(w.mean())) < 0.05 * scale, name
    again = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(params[n], again[n]) for n in want)
    bf16 = tmoe.init_moe(torch.Generator().manual_seed(0),
                         dataclasses.replace(cfg, param_dtype="bfloat16"))
    assert all(w.dtype == torch.bfloat16 for w in bf16.values())


def test_moe_block_refuses_an_unknown_impl():
    _, _, tcfg, tparams = _setup("granite-moe-1b-a400m", moe_impl="gshard")
    with pytest.raises(ValueError, match="moe_impl"):
        tmoe.moe_block(tparams, tcfg, torch.zeros((1, 4, tcfg.d_model)))


def test_scatter_writes_no_float_accumulation():
    """The scatter path's dispatch is plain index assignment: no
    ``index_add_``/``index_put_(accumulate=True)``/``scatter_add`` among
    the aten ops it dispatches, at a capacity that drops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.seen.append((str(func), bool(kwargs.get(
                "accumulate", len(args) > 3 and args[3] is True))))
            return func(*args, **kwargs)

    _, _, tcfg, tparams = _setup("qwen3-moe-235b-a22b", capacity_factor=0.25)
    _, tx = _x(tcfg, (2, 13), seed=4)
    with Ops() as ops:
        tmoe.moe_block(tparams, tcfg, tx)
    names = [name for name, _ in ops.seen]
    assert any("index_put" in n for n in names)
    assert not any(acc for name, acc in ops.seen if "index_put" in name)
    assert not any("index_add" in n or "scatter_add" in n
                   or "scatter_reduce" in n for n in names)
