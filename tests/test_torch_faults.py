"""The port's fault layer (``repro_torch.distributed.faults`` and the
faulty drivers) against the JAX reference and its own fault-free drivers,
on the CPU; and the DES's distributed backend.

  * Fault plans are numpy ``default_rng`` draws: the port's plans equal
    the reference's field by field (values and dtypes).
  * A zero-fault plan pushed through the faulty drivers is bitwise the
    fault-free run, on all four drivers.
  * Under injected faults every run recovers within the repair budget or
    raises a typed ``FaultToleranceError``; the port's faulty runs land
    on the reference's (assignment, move and turn counts, every field of
    the report), on ct against the reference's ``jnp`` drivers and on c
    against its ``cost_fn="pallas"`` drivers (the reference's ``jnp``
    drivers cycle on c, ROADMAP queue 3, caveat 1).
  * Fault traffic is measured and reconciles byte-exactly with the ledger.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.distributed as JD
from repro.distributed import faults as JF
from repro.graphs.generators import random_degree_graph
from repro_torch import distributed as PD
from repro_torch.core.batch import stack_pytrees, unstack_pytree
from repro_torch.des import engine as P
from repro_torch.des import scenarios as PS
from repro_torch.distributed import faults as PF
from repro_torch.distributed.accounting import reconcile
from repro_torch.graphs import generators as pgen

from test_torch_distributed import _pair

torch.set_num_threads(1)

N, K, S = 64, 4, 4
PLAN_ROUNDS = 96
MIXED = dict(p_down=0.03, down_length=(2, 4), p_omit=0.05, p_lost=0.2,
             p_dup=0.08, p_corrupt=0.04, num_machines=K, num_nodes=N)


@pytest.fixture(scope="module")
def pair():
    return _pair(n=N, k=K, seed=0)


def _plans(seed, rounds=PLAN_ROUNDS, **overrides):
    kw = dict(MIXED, **overrides)
    return (JF.make_fault_plan(rounds, S, seed, **kw),
            PF.make_fault_plan(rounds, S, seed, **kw))


def _permanent_down_plan(rounds, shards, shard=0):
    """A plan no degraded mode can absorb: one shard down every round."""
    z = np.zeros((rounds, shards), bool)
    down = z.copy()
    down[:, shard] = True
    return PF._assemble(down, z, np.zeros((rounds, shards), np.int32), z,
                        z, np.zeros((rounds, shards), np.int32),
                        np.zeros((rounds, shards), np.float32),
                        PF.DEFAULT_DEGRADED, 0)


def _eq(a, b, label=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (label, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=label)


def _same(want, got, fields=("assignment", "loads", "num_moves",
                             "num_turns", "converged")):
    for f in fields:
        _eq(getattr(want, f), getattr(got, f), f)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 7, 1234])
def test_fault_plans_equal_reference(seed):
    for overrides in ({}, dict(p_corrupt=0.15, nan_frac=1.0),
                      dict(p_down=0.2, down_length=(5, 9), p_lost=0.5)):
        want, got = _plans(seed, **overrides)
        for f in want._fields:
            _eq(getattr(want, f), getattr(got, f), f)
        assert (got.horizon, got.num_shards) == (want.horizon,
                                                 want.num_shards)
        assert isinstance(got.down, np.ndarray)


def test_plan_helpers_equal_reference():
    want, got = _plans(11)
    for traced in (False, True):
        for sim in (False, True):
            wm = JF.message_bytes(traced=traced, simultaneous=sim,
                                  num_machines=K)
            assert PF.message_bytes(traced=traced, simultaneous=sim,
                                    num_machines=K) == wm
            for rounds in (0, 17, PLAN_ROUNDS + 5):
                assert PF.plan_extra_bytes(got, rounds, wm) \
                    == JF.plan_extra_bytes(want, rounds, wm)
    for t in (0, 5, PLAN_ROUNDS, PLAN_ROUNDS + 3):
        row = PF.plan_row(got, t)
        ref = JF.plan_row(want, t)
        for f in ref._fields:
            _eq(getattr(ref, f), getattr(row, f), f)
        assert PF.round_extra_bytes(row, 16) == int(JF.round_extra_bytes(
            ref, 16))
    zero_w, zero_g = JF.zero_fault_plan(8, 3), PF.zero_fault_plan(8, 3)
    for f in zero_w._fields:
        _eq(getattr(zero_w, f), getattr(zero_g, f), f)
    assert PF.DegradedMode() == PF.DEFAULT_DEGRADED
    assert dataclasses.asdict(PF.DEFAULT_DEGRADED) == dataclasses.asdict(
        JF.DEFAULT_DEGRADED)


def test_exchange_loss_is_fault_plan():
    from repro.des import scenarios as JS
    got = PS.refine_exchange_loss(32, S, seed=1, p_lost=0.3)
    want = JS.refine_exchange_loss(32, S, seed=1, p_lost=0.3)
    assert isinstance(got, PF.FaultPlan)
    assert got.num_shards == S and got.horizon == 32
    assert int(got.lost.sum()) > 0
    for f in want._fields:
        _eq(getattr(want, f), getattr(got, f), f)


def test_error_types_and_reports():
    assert issubclass(PD.DeadShardError, PD.FaultToleranceError)
    assert issubclass(PD.RecoveryFailedError, PD.FaultToleranceError)
    assert issubclass(PD.FaultToleranceError, RuntimeError)
    plan = PF.zero_fault_plan(8, 2)
    ok = PF.FaultOutcome(torch.tensor(0.0), torch.tensor(0.0), False,
                         torch.tensor(0), torch.tensor(0), torch.tensor(0.0))
    report = PF.build_report(plan, ok, 5)
    assert report.recovered and report.rounds == 5
    assert report.recovery_round is None
    bad = ok._replace(post_drift=torch.tensor(float("inf")))
    with pytest.raises(PD.RecoveryFailedError) as info:
        PF.build_report(plan, bad, 5, budget=1e-3)
    assert info.value.report is not None and not info.value.report.recovered
    dead = PF.build_report(plan, ok._replace(dead=True), 5,
                           raise_on_failure=False)
    with pytest.raises(PD.DeadShardError):
        PF.raise_if_failed(dead)
    # fault telemetry is ported: a clear plan emits nothing, a faulty one
    # its faults
    from repro_torch.obs import Recorder
    rec = Recorder()
    PF.emit_fault_events(rec, "run", plan, 5)
    assert rec.events == []
    PF.emit_fault_events(rec, "run", _plans(0)[1], PLAN_ROUNDS)
    assert {e["kind"] for e in rec.events} >= {"fault_injected",
                                               "exchange_retry"}


# ---------------------------------------------------------------------------
# zero-fault bitwise identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("framework", ["c", "ct"])
def test_zero_fault_plain_bitwise(pair, framework):
    _, prob, r0 = pair
    ref = PD.refine_distributed(prob, r0, framework, num_shards=S)
    res, report = PD.refine_distributed(
        prob, r0, framework, num_shards=S,
        fault_plan=PD.zero_fault_plan(PLAN_ROUNDS, S))
    _same(ref, res)
    assert report.recovered and not report.dead
    assert report.retries == 0 and report.repairs == 0
    assert report.recovery_drift <= PF.DEFAULT_DEGRADED.repair_tol


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_zero_fault_traced_bitwise(pair, framework):
    _, prob, r0 = pair
    ref, ref_tr = PD.refine_distributed_traced(prob, r0, framework,
                                               num_shards=S, max_turns=256)
    res, tr, report = PD.refine_distributed_traced(
        prob, r0, framework, num_shards=S, max_turns=256,
        fault_plan=PD.zero_fault_plan(PLAN_ROUNDS, S))
    _same(ref, res)
    for f in ref_tr._fields:
        _eq(getattr(ref_tr, f), getattr(tr, f), f)
    assert report.recovered


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_zero_fault_sweep_bitwise(pair, framework):
    _, prob, r0 = pair
    ref, outs = PD.refine_distributed_simultaneous(prob, r0, framework,
                                                   num_shards=S,
                                                   max_sweeps=96)
    res, fouts, report = PD.refine_distributed_simultaneous(
        prob, r0, framework, num_shards=S, max_sweeps=96,
        fault_plan=PD.zero_fault_plan(PLAN_ROUNDS, S))
    _same(ref, res)
    for a, b in zip(outs, fouts):
        _eq(a, b)
    assert report.recovered


def test_zero_fault_shard_map_bitwise(pair):
    _, prob, r0 = pair
    ref = PD.refine_distributed_shard_map(prob, r0, "c", num_shards=1)
    res, report = PD.refine_distributed_shard_map(
        prob, r0, "c", num_shards=1,
        fault_plan=PD.zero_fault_plan(PLAN_ROUNDS, 1))
    _same(ref, res)
    assert report.recovered and not report.dead


def test_shard_map_faulty_equals_emulated(pair):
    """The collective faulty path (a group of one) and the emulated one
    agree on a mixed plan: result, report and measured wire."""
    _, prob, r0 = pair
    plan = PF.make_fault_plan(PLAN_ROUNDS, 1, 3, p_omit=0.05, p_lost=0.2,
                              p_dup=0.08, p_corrupt=0.04, num_machines=K,
                              num_nodes=N)
    got = PD.refine_distributed_shard_map(prob, r0, "c", num_shards=1,
                                          fault_plan=plan, measure_wire=True)
    want = PD.refine_distributed(prob, r0, "c", num_shards=1,
                                 fault_plan=plan, measure_wire=True)
    _same(want[0], got[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert got[2].repairs > 0


# ---------------------------------------------------------------------------
# recover-or-raise, and the reference's outcomes
# ---------------------------------------------------------------------------

def _run(mode, prob, r0, framework, plan, lib, **kw):
    if mode == "plain":
        return lib.refine_distributed(prob, r0, framework, num_shards=S,
                                      fault_plan=plan, **kw)
    if mode == "traced":
        return lib.refine_distributed_traced(prob, r0, framework,
                                             num_shards=S, max_turns=256,
                                             fault_plan=plan, **kw)[::2]
    return lib.refine_distributed_simultaneous(prob, r0, framework,
                                               num_shards=S, max_sweeps=96,
                                               fault_plan=plan, **kw)[::2]


REPORT = ("recovered", "dead", "repairs", "repaired_cols", "retries", "dups",
          "down_rounds", "stale_rounds", "quarantined_rounds",
          "recovery_round", "rounds")


@pytest.mark.parametrize("seed", [3, 7, 11])
@pytest.mark.parametrize("framework,mode", [
    ("c", "plain"), ("c", "traced"), ("c", "sweep"), ("ct", "plain")])
def test_faulty_runs_match_reference(pair, framework, mode, seed):
    jp, prob, r0 = pair
    jplan, pplan = _plans(seed)
    cost_fn = "pallas" if framework == "c" else "jnp"
    want, wrep = _run(mode, jp, jnp.asarray(r0), framework, jplan, JD,
                      cost_fn=cost_fn)
    got, grep_ = _run(mode, prob, r0, framework, pplan, PD,
                      **({"cost_fn": cost_fn} if mode != "plain" else {}))
    _eq(want.assignment, got.assignment)
    assert int(got.num_moves) == int(want.num_moves)
    assert int(got.num_turns) == int(want.num_turns)
    for f in REPORT:
        assert getattr(grep_, f) == getattr(wrep, f), f
    np.testing.assert_allclose(got.loads.numpy(), np.asarray(want.loads),
                               rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 5, 14, 99, 2024, 65535])
def test_random_fault_plans_recover_or_raise(pair, seed):
    """ANY seeded plan recovers within the repair budget or raises a typed
    FaultToleranceError — never a silent bad result."""
    _, prob, r0 = pair
    plan = PF.make_fault_plan(PLAN_ROUNDS, S, seed, **MIXED)
    for mode in ("plain", "traced", "sweep"):
        try:
            res, report = _run(mode, prob, r0, "c", plan, PD)
        except PD.FaultToleranceError as err:
            assert err.report is not None
            assert err.report.dead or not err.report.recovered
            continue
        assert report.recovered
        assert report.recovery_drift <= PF.DEFAULT_DEGRADED.repair_tol
        r = res.assignment
        assert int(r.min()) >= 0 and int(r.max()) < K
        assert bool(torch.isfinite(res.loads).all())


def test_transient_faults_recover(pair):
    _, prob, r0 = pair
    plan = PF.make_fault_plan(PLAN_ROUNDS, S, 7, **MIXED)
    res, report = PD.refine_distributed(prob, r0, "c", num_shards=S,
                                        fault_plan=plan)
    assert report.recovered and not report.dead
    assert report.down_rounds > 0 or report.retries > 0
    assert bool(torch.isfinite(res.loads).all())


def test_nan_corruption_repaired(pair):
    _, prob, r0 = pair
    plan = PF.make_fault_plan(PLAN_ROUNDS, S, 3, **dict(
        MIXED, p_down=0.0, p_omit=0.0, p_lost=0.0, p_dup=0.0,
        p_corrupt=0.15, nan_frac=1.0))
    res, report = PD.refine_distributed(prob, r0, "c", num_shards=S,
                                        fault_plan=plan)
    assert report.recovered and report.repairs > 0
    assert bool(torch.isfinite(res.loads).all())
    assert report.max_repair_drift > PF.DEFAULT_DEGRADED.repair_tol


def test_permanent_down_raises_dead_shard(pair):
    _, prob, r0 = pair
    plan = _permanent_down_plan(PLAN_ROUNDS, S, shard=1)
    for run in (lambda: PD.refine_distributed(
                    prob, r0, "c", num_shards=S, fault_plan=plan,
                    max_turns=PLAN_ROUNDS // 2),
                lambda: PD.refine_distributed_traced(
                    prob, r0, "c", num_shards=S, fault_plan=plan,
                    max_turns=PLAN_ROUNDS // 2)):
        with pytest.raises(PD.DeadShardError) as info:
            run()
        report = info.value.report
        assert report is not None and report.dead and not report.recovered
    with pytest.raises(PD.DeadShardError):
        PD.refine_distributed_shard_map(
            prob, r0, "c", num_shards=1, max_turns=PLAN_ROUNDS // 2,
            fault_plan=_permanent_down_plan(PLAN_ROUNDS, 1))


def test_faulty_rejects_recompute_path_and_wrong_plan(pair):
    _, prob, r0 = pair
    with pytest.raises(ValueError, match="incremental"):
        PD.refine_distributed(prob, r0, "c", num_shards=S,
                              incremental=False,
                              fault_plan=PD.zero_fault_plan(8, S))
    with pytest.raises(ValueError, match="shards"):
        PD.refine_distributed(prob, r0, "c", num_shards=S,
                              fault_plan=PD.zero_fault_plan(8, S + 1))


# ---------------------------------------------------------------------------
# wire accounting: fault traffic is measured and reconciled byte-exactly
# ---------------------------------------------------------------------------

def test_fault_wire_reconciles_byte_exact(pair):
    _, prob, r0 = pair
    plan = PF.make_fault_plan(PLAN_ROUNDS, S, 11, **MIXED)
    stats = PD.boundary_stats(prob, S)
    res, wire, report = PD.refine_distributed(
        prob, r0, "c", num_shards=S, fault_plan=plan, measure_wire=True)
    rounds = int(res.num_turns)
    extra = PF.plan_extra_bytes(plan, rounds, PF.message_bytes(
        traced=False, simultaneous=False, num_machines=K))
    assert extra > 0
    led = PD.ledger_for_run(stats, K, rounds, fault_bytes=extra)
    check = reconcile(led, wire)
    assert check.ok, check
    assert wire.payload_bytes == led.candidate_bytes + led.trace_bytes \
        + led.fault_bytes
    assert led.per_round_bytes == PD.ledger_for_run(stats, K,
                                                    rounds).per_round_bytes


def test_fault_wire_reconciles_traced_and_sweep(pair):
    _, prob, r0 = pair
    plan = PF.make_fault_plan(PLAN_ROUNDS, S, 13, **dict(
        MIXED, p_down=0.0, p_corrupt=0.0))
    stats = PD.boundary_stats(prob, S)
    res, _, wire, _ = PD.refine_distributed_traced(
        prob, r0, "c", num_shards=S, max_turns=256, fault_plan=plan,
        measure_wire=True)
    extra = PF.plan_extra_bytes(plan, int(res.num_turns), PF.message_bytes(
        traced=True, simultaneous=False, num_machines=K))
    assert reconcile(PD.ledger_for_run(stats, K, int(res.num_turns),
                                       traced=True, fault_bytes=extra),
                     wire).ok
    res, _, wire, _ = PD.refine_distributed_simultaneous(
        prob, r0, "c", num_shards=S, max_sweeps=96, fault_plan=plan,
        measure_wire=True)
    extra = PF.plan_extra_bytes(plan, int(res.num_turns), PF.message_bytes(
        traced=False, simultaneous=True, num_machines=K))
    assert reconcile(PD.ledger_for_run(stats, K, int(res.num_turns),
                                       simultaneous=True, fault_bytes=extra),
                     wire).ok


# ---------------------------------------------------------------------------
# the DES's distributed backend
# ---------------------------------------------------------------------------

def _des(n=24, k=3, t=6, seed=1, **cfg):
    adj = pgen.random_degree_graph(n, seed=seed, dmin=2, dmax=3)
    from repro_torch.des.workload import flooded_packet_workload
    spec = flooded_packet_workload(adj, 11, num_threads=t, scope=2,
                                   max_per_lp=3)
    base = dict(num_lps=n, num_machines=k, num_threads=t,
                event_capacity=32, history_capacity=64, refine_freq=150,
                max_ticks=40_000)
    base.update(cfg)
    config = P.DESConfig(**base)
    state = P.make_initial_state(config, np.arange(n) % k, spec.src,
                                 spec.time, spec.count, device="cpu")
    return config, adj, state


def _fields(state):
    """(name, leaf) of every ``DESState`` field: ``chip_smoke.des_fields``,
    the walk the card's checks use."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.des_fields(state)


def _des_same(a, b):
    fb = dict(_fields(b))
    bad = [name for name, x in _fields(a) if not torch.equal(x, fb[name])]
    assert not bad, bad


@pytest.mark.parametrize("framework,shards", [("c", 0), ("ct", 2)])
def test_des_distributed_backend_equals_single(framework, shards):
    cfg, adj, state = _des(refine_framework=framework,
                           refine_theta_scale=2.0)
    single = P.run_simulation(cfg, adj, state)
    dcfg = dataclasses.replace(cfg, refine_backend="distributed",
                               refine_num_shards=shards)
    got = P.run_simulation(dcfg, adj, state)
    assert bool(got.done) and int(got.refines) > 0
    _des_same(single, got)


def test_des_fleet_distributed_equals_lone_runs():
    cfg, adj, s0 = _des(n=16, t=4, refine_framework="ct", refine_freq=90)
    dcfg = dataclasses.replace(cfg, refine_backend="distributed")
    _, adj1, s1 = _des(n=16, t=4, seed=4, refine_framework="ct",
                       refine_freq=90)
    fleet = P.run_simulation_batch(
        dcfg, torch.stack([torch.as_tensor(adj, dtype=torch.float32),
                           torch.as_tensor(adj1, dtype=torch.float32)]),
        stack_pytrees([s0, s1]))
    assert bool(fleet.done.all()) and int(fleet.refines.min()) > 0
    for b, (a, s) in enumerate(((adj, s0), (adj1, s1))):
        _des_same(P.run_simulation(dcfg, a, s), unstack_pytree(fleet, b))


def test_des_distributed_matches_reference():
    """The reference's own distributed-backend DES test case, on ct (the
    reference's jnp drivers converge there): machine map, moves, ticks."""
    from repro.des.engine import (DESConfig, make_initial_state,
                                  run_simulation)
    from repro.des.workload import flooded_packet_workload
    n, t = 24, 6
    adj = random_degree_graph(n, seed=1, dmin=2, dmax=3)
    spec = flooded_packet_workload(adj, 11, num_threads=t, scope=2,
                                   max_per_lp=3)
    m0 = np.arange(n) % 3
    kw = dict(num_lps=n, num_machines=3, num_threads=t, event_capacity=32,
              history_capacity=64, refine_freq=150, max_ticks=40_000,
              refine_framework="ct", refine_backend="distributed")
    jcfg = DESConfig(**kw)
    want = run_simulation(jcfg, jnp.asarray(adj, jnp.float32),
                          make_initial_state(jcfg, jnp.asarray(m0, jnp.int32),
                                             spec.src, spec.time,
                                             spec.count))
    pcfg = P.DESConfig(**kw)
    got = P.run_simulation(pcfg, adj, P.make_initial_state(
        pcfg, m0, spec.src, spec.time, spec.count, device="cpu"))
    assert int(got.refines) == int(want.refines) > 0
    _eq(want.machine, got.machine)
    assert int(got.moves) == int(want.moves)
    assert int(got.tick) == int(want.tick)
    _eq(want.seen, got.seen)


