"""The port's expert and pipeline-stage planner against the reference, on
the CPU (``tests/test_planner.py``'s instances).

``expert_placement`` and ``stage_assignment`` give the reference's
permutation, assignment and stats.  On framework c the reference's jnp
``refine`` can make one-ULP self-moves (ROADMAP queue 3, caveat 1), so
there the port is held against the reference's kernel path — ``refine``
with the Pallas dissatisfaction kernel in interpret mode, then its
``equalize_cardinality`` or ``make_contiguous`` — and against the
reference's planner directly where its path makes no self-move.  Move
counts and assignments are exact; imbalances, f32 ratios of sums taken in
two libraries' orders, within 1e-6.  The 7-step planner loop runs both
packages from one state, replan for replan.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import constrained as jcon
from repro.core.problem import make_problem as jmake_problem
from repro.core.refine import refine as jrefine
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.sharding import planner as jplanner
from repro.training import data as jdata
from repro.training import train_step as jstep
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference)
from repro_torch.sharding import (PartitionPlanner, apply_expert_permutation,
                                  expert_placement, stage_assignment)
from repro_torch.training import data as tdata
from repro_torch.training import train_step as tstep
from repro_torch.training.tree import flatten

torch.set_num_threads(1)


def _skewed(e=16, seed=0):
    """``test_planner.py``'s instance: four hot experts, uniform random
    symmetric co-activation."""
    rng = np.random.default_rng(seed)
    load = np.ones(e, np.float32)
    load[:4] = 50.0
    coact = rng.uniform(0, 1, (e, e)).astype(np.float32)
    coact = np.triu(coact, 1)
    return load, coact + coact.T


def _reference_kernel_path(load, coact, g, framework, current):
    """The reference's ``expert_placement`` with its refine on the
    dissatisfaction kernel (interpret mode)."""
    e = load.shape[0]
    lj = jnp.asarray(load) + 1e-6
    cj = jnp.asarray(coact)
    cj = cj * (jnp.max(lj) / jnp.maximum(jnp.max(cj), 1e-6))
    prob = jmake_problem(cj, lj, jnp.full((g,), 1.0, jnp.float32), mu=1.0)
    res = jrefine(prob, jnp.asarray(current), framework, max_turns=4 * e,
                  dissat_fn=jops.make_aggregate_dissat_fn(interpret=True))
    balanced = jcon.equalize_cardinality(prob, res.assignment, framework)
    return (np.asarray(jnp.argsort(balanced, stable=True)),
            np.asarray(balanced), int(res.num_moves))


CURRENTS = {"round robin": lambda e, g: np.arange(e) % g,
            "hot on group 0": lambda e, g: np.arange(e) // (e // g)}


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("current", sorted(CURRENTS))
def test_expert_placement_matches_reference(framework, current):
    load, coact = _skewed()
    e, g = 16, 4
    cur = CURRENTS[current](e, g).astype(np.int32)
    perm, assign, stats = expert_placement(
        torch.from_numpy(load), torch.from_numpy(coact), g,
        framework=framework, current=torch.from_numpy(cur))
    kperm, kassign, kmoves = _reference_kernel_path(load, coact, g,
                                                    framework, cur)
    assert perm.dtype == torch.int32
    assert np.array_equal(perm.numpy(), kperm)
    assert np.array_equal(assign.numpy(), kassign)
    assert stats["moves"] == kmoves
    assert np.bincount(assign.numpy(), minlength=g).tolist() == [4] * g
    jperm, jassign, jstats = jplanner.expert_placement(
        jnp.asarray(load), jnp.asarray(coact), g, framework=framework,
        current=jnp.asarray(cur))
    for name in ("imbalance_before", "imbalance_after"):
        assert stats[name] == pytest.approx(jstats[name], rel=1e-6), name
    if framework == "ct":       # no self-move: the reference's own path
        assert np.array_equal(perm.numpy(), np.asarray(jperm))
        assert np.array_equal(assign.numpy(), np.asarray(jassign))
        assert stats["moves"] == jstats["moves"]
    if current == "hot on group 0":
        assert stats["imbalance_before"] > 3.0
        assert stats["imbalance_after"] < 2.0


def test_expert_placement_default_start_equals_reference_planner():
    """The default start (round robin) on framework c: the same
    permutation as the reference's own planner; its jnp path takes one
    more (self-)move than the kernel path."""
    load, coact = _skewed()
    perm, _, stats = expert_placement(torch.from_numpy(load),
                                      torch.from_numpy(coact), 4)
    jperm, _, jstats = jplanner.expert_placement(jnp.asarray(load),
                                                 jnp.asarray(coact), 4)
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    assert stats["moves"] <= jstats["moves"]
    with pytest.raises(ValueError, match="equal groups"):
        expert_placement(torch.from_numpy(load), torch.from_numpy(coact), 3)


STAGE_CASES = {
    "uniform costs, L=24, S=4": (
        np.random.default_rng(1).uniform(1.0, 3.0, 24).astype(np.float32),
        128.0, 4),
    "hybrid, L=18, S=3": (
        np.where(np.isin(np.arange(18), [5, 11, 17]), 3.0, 1.0).astype(
            np.float32), 4.0, 3),
}


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_stage_assignment_matches_reference(case, framework):
    cost, bb, stages = STAGE_CASES[case]
    got, game_max, dp_max = stage_assignment(cost, bb, stages,
                                             framework=framework,
                                             device="cpu")
    want, jgame, jdp = jplanner.stage_assignment(cost, bb, stages,
                                                 framework=framework)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert game_max == jgame and dp_max == jdp
    a = got.numpy()
    assert np.all(np.diff(a) >= 0) and a.min() == 0 and a.max() == stages - 1
    assert game_max <= dp_max * 1.3


def test_expert_permutation_preserves_moe_function():
    """Permuting the expert weights and router columns leaves the MoE
    block's map unchanged (within the reference's 2e-4), and permutes
    exactly as the reference's ``apply_expert_permutation``."""
    jcfg = jconfigs.get_smoke_config("granite-moe-1b-a400m")
    tcfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    jm = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    stacked = {"blocks": jax.tree.map(lambda p: p[None], {"moe": jm})}
    params = params_from_reference(jax.tree.map(np.asarray, stacked),
                                   device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(
        tcfg.num_experts).astype(np.int32))
    permuted = apply_expert_permutation(params, perm)
    y0, _ = tmoe.moe_block(params["blocks"][0]["moe"], tcfg, x)
    y1, _ = tmoe.moe_block(permuted["blocks"][0]["moe"], tcfg, x)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=2e-4, atol=2e-4)
    want = params_from_reference(jax.tree.map(
        np.asarray, jplanner.apply_expert_permutation(
            stacked, jnp.asarray(perm.numpy()))), device="cpu")
    for (path, a), b in zip(zip(*flatten(permuted)), flatten(want)[1]):
        assert torch.equal(a, b), path
    assert not torch.equal(permuted["blocks"][0]["moe"]["gate"],
                           params["blocks"][0]["moe"]["gate"])


@pytest.mark.parametrize("groups", [4, 2])
def test_planner_replan_in_training_loop_matches_reference(groups):
    """``test_planner.py``'s loop (granite-moe smoke, replans at steps 3
    and 6) from one state in both packages: each replan's stats,
    permutation and every state within the training budget, losses
    finite and falling.  Its 4 experts in 4 groups never move; in 2
    groups the replans permute the params, moments and statistics."""
    jcfg = jconfigs.get_smoke_config("granite-moe-1b-a400m")
    tcfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    jstate = jstep.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = train_state_from_reference(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jstep.TrainHyper(total_steps=10, warmup=1)))
    tfn = tstep.make_train_step(tcfg, tstep.TrainHyper(total_steps=10,
                                                       warmup=1))
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4)
    jd, td = jdata.SyntheticDataConfig(**kw), tdata.SyntheticDataConfig(**kw)
    jp, tp = jplanner.PartitionPlanner(num_groups=groups, interval=3), \
        PartitionPlanner(num_groups=groups, interval=3)
    losses, replans, moved = [], 0, 0
    for i in range(7):
        jstate, jm = jfn(jstate, jdata.synthetic_batch(jd, i))
        tstate, tm = tfn(tstate, tdata.synthetic_batch(td, i, device="cpu"))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=5e-3)
        losses.append(float(tm["loss"]))
        jstate, jstats = jp.maybe_replan(i + 1, jstate)
        tstate, tstats = tp.maybe_replan(i + 1, tstate)
        assert (jstats is None) == (tstats is None)
        if tstats is not None:
            replans += 1
            for name in ("imbalance_before", "imbalance_after"):
                assert tstats[name] == pytest.approx(jstats[name],
                                                     rel=1e-5), name
            assert tstats["moves"] == jstats["moves"]
            assert (tp._last_perm is None) == (jp._last_perm is None)
            if jp._last_perm is not None:
                moved += 1
                assert np.array_equal(tp._last_perm.numpy(),
                                      np.asarray(jp._last_perm))
        got = flatten(tstate)[1]
        want = flatten(train_state_from_reference(
            jax.tree.map(np.asarray, jstate), device="cpu"))[1]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=5e-3, atol=5e-4)
    assert replans == 2 and moved == (0 if groups == 4 else 2)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_planner_skips_what_the_reference_skips():
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    state = tstep.init_train_state(cfg, 0, device="cpu")
    planner = PartitionPlanner(num_groups=2, interval=3)
    for step in (0, 1, 4):
        assert planner.maybe_replan(step, state) == (state, None)
    # no router statistics yet
    assert planner.maybe_replan(3, state) == (state, None)
    assert PartitionPlanner(num_groups=1, interval=1).maybe_replan(
        1, state) == (state, None)
