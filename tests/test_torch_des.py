"""The port's Time-Warp DES against the JAX reference, on the CPU.

Both packages run the same workload (``flooded_packet_workload`` from a
numpy seed), the same topology and the same initial placement; every
field of the final ``DESState`` — integer, boolean and float, the event
lists, histories, ``seen_time`` and both load traces included — must be
bitwise equal.  No tolerance is needed: every float the tick computes is
one f32 operation on equal inputs, every count an integer sum, every
minimum exact; each refinement round's game has integer weights, and its
speeds are normalized by a sum in machine order, the reference's.

Framework c is held to the same bitwise standard as ct.  The reference's
DES refines through its jnp ``refine`` (``des/engine.py:745-750``), which
on framework c can leave the kernel path after a one-ULP source==dest
move (ROADMAP queue 3, caveat 1); on every DES case here it does not, so
the result recorded is parity, round for round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.batch import stack_pytrees as j_stack
from repro.des import engine as J
from repro.des import scenarios as JS
from repro.des.workload import flooded_packet_workload as j_workload
from repro.graphs.generators import (preferential_attachment,
                                     random_degree_graph,
                                     specialized_geometric)
from repro_torch.core.batch import stack_pytrees, unstack_pytree
from repro_torch.des import engine as P
from repro_torch.des import scenarios as PS
from repro_torch.des.workload import flooded_packet_workload

torch.set_num_threads(1)


def _smoke():
    """``chip_smoke.py`` as a module, for its walk over ``DESState``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


_fields = _smoke().des_fields   # (name, leaf) of the reference's or port's


def _assert_same(want, got, label=""):
    """Every field bitwise; on a miss, name the fields and the rounds."""
    got_f = dict(_fields(got))
    bad = [name for name, w in _fields(want)
           if not np.array_equal(np.asarray(w), got_f[name].numpy())]
    assert not bad, (f"{label}: fields differ {bad}; refines "
                     f"{int(np.asarray(want.refines).max())} / "
                     f"{int(got.refines.max())}, ticks "
                     f"{np.asarray(want.tick)} / {got.tick.numpy()}")


def _setup(n, k, t, seed, graph="pa", **cfg):
    adj = preferential_attachment(n, seed=seed, m=2) if graph == "pa" \
        else specialized_geometric(n, seed)
    spec = flooded_packet_workload(adj, seed + 2, num_threads=t,
                                   num_windows=2, window_sim_time=30.0,
                                   scope=2, max_per_lp=3)
    deg = int((adj > 0).sum(1).max())
    base = dict(num_lps=n, num_machines=k, num_threads=t,
                event_capacity=max(48, 2 * deg + 8),
                history_capacity=max(96, 4 * deg + 16), inter_delay=5,
                trace_stride=10, max_ticks=40_000)
    base.update(cfg)
    return adj, spec, J.DESConfig(**base), P.DESConfig(**base)


def _states(jcfg, pcfg, spec, m0):
    js = J.make_initial_state(jcfg, jnp.asarray(m0, jnp.int32), spec.src,
                              spec.time, spec.count)
    ps = P.make_initial_state(pcfg, m0, spec.src, spec.time, spec.count,
                              device="cpu")
    return js, ps


def _pair(name, k, *args, **kwargs):
    return (getattr(JS, name)(k, *args, **kwargs),
            getattr(PS, name)(k, *args, **kwargs))


# (id, n, k, threads, seed, config, schedule builder or None)
_REFINED = dict(refine_freq=60, refine_framework="ct")
_THETA = dict(_REFINED, refine_theta_scale=5.0, migration_freeze=0.25)
CASES = [
    ("static-k1", 16, 1, 6, 4, dict(), None),
    ("static-k3", 24, 3, 8, 4, dict(), None),
    ("ct", 24, 3, 8, 4, _REFINED, None),
    ("ct-theta-freeze", 24, 3, 8, 4, _THETA, None),
    ("c", 24, 3, 8, 4, dict(refine_freq=60), None),
    ("c-theta-freeze", 24, 3, 8, 4,
     dict(_THETA, refine_framework="c"), None),
    ("ct-slowdown", 24, 3, 8, 4, _THETA,
     ("slowdown", dict(machine=0, at_tick=90, factor=0.3, recover_tick=300))),
    ("ct-failure-recovery", 24, 3, 8, 4, _THETA,
     ("failure_recovery", dict(machine=1, fail_tick=50, recover_tick=250))),
    ("ct-true-failure", 24, 3, 8, 4, _THETA,
     ("true_failure", dict(machine=2, fail_tick=40, recover_tick=200))),
    ("ct-random-churn", 24, 3, 8, 4, _THETA,
     ("random_churn", dict(num_segments=4, segment_ticks=100, seed=3))),
    ("c-geometric-n40-k5", 40, 5, 10, 1,
     dict(graph="geometric", refine_freq=50), None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_run_simulation_matches_reference(case):
    name, n, k, t, seed, cfg, sched = case
    adj, spec, jcfg, pcfg = _setup(n, k, t, seed, **cfg)
    js, ps = _states(jcfg, pcfg, spec, np.arange(n) % k)
    j_sched = p_sched = None
    if sched is not None:
        j_sched, p_sched = _pair(sched[0], k, **sched[1])
    want = J.run_simulation(jcfg, jnp.asarray(adj, jnp.float32), js,
                            j_sched)
    got = P.run_simulation(pcfg, adj, ps, p_sched)
    assert bool(got.done)
    assert int(got.dropped) == 0 and int(got.hist_evict) == 0
    if cfg.get("refine_freq"):
        assert int(got.refines) >= 3
    _assert_same(want, got, name)


def test_des_tick_matches_reference():
    """The public one-tick entry point, refinement phase P6 included."""
    adj, spec, jcfg, pcfg = _setup(16, 3, 6, 3, refine_freq=10,
                                   refine_framework="ct",
                                   refine_theta_scale=2.0,
                                   migration_freeze=0.5)
    js, ps = _states(jcfg, pcfg, spec, np.arange(16) % 3)
    tick = jax.jit(lambda a, s: J.des_tick(jcfg, a, s))
    adjj = jnp.asarray(adj, jnp.float32)
    for _ in range(45):
        js = tick(adjj, js)
        ps = P.des_tick(pcfg, adj, ps)
    assert int(ps.refines) == 4
    _assert_same(js, ps, "des_tick")


def _hop_closure(adj, src, hops):
    mask = np.zeros(adj.shape[0], bool)
    mask[src] = True
    for _ in range(hops):
        mask = mask | (mask @ (adj > 0))
    return mask


@pytest.mark.parametrize("num_machines,seed", [(1, 0), (3, 1), (5, 2)])
def test_flood_closure_oracle(num_machines, seed):
    """The port's own oracle: final seen-sets are the exact k-hop closures
    under any placement, delays, stragglers and rollbacks."""
    n, t = 24, 6
    adj = random_degree_graph(n, seed=seed, dmin=2, dmax=3)
    spec = flooded_packet_workload(adj, seed + 10, num_threads=t, scope=2,
                                   max_per_lp=3)
    cfg = P.DESConfig(num_lps=n, num_machines=num_machines, num_threads=t,
                      event_capacity=32, history_capacity=64,
                      max_ticks=40_000)
    state = P.make_initial_state(cfg, np.arange(n) % num_machines,
                                 spec.src, spec.time, spec.count,
                                 device="cpu")
    out = P.run_simulation(cfg, adj, state)
    assert bool(out.done)
    assert int(out.dropped) == 0 and int(out.hist_evict) == 0
    seen = out.seen.numpy()
    for j in range(t):
        np.testing.assert_array_equal(
            seen[:, j], _hop_closure(adj, int(spec.src[j]),
                                     int(spec.count[j])))


def _batch_fixture(refine_freq=60, theta_scale=5.0, freeze=0.25):
    n, k, t = 16, 3, 6
    adj = preferential_attachment(n, 3, m=2)
    spec = flooded_packet_workload(adj, 7, num_threads=t, num_windows=2,
                                   scope=2, window_sim_time=30.0,
                                   max_per_lp=3)
    cfg = dict(num_lps=n, num_machines=k, num_threads=t, event_capacity=32,
               history_capacity=64, inter_delay=5, intra_delay=1,
               trace_stride=10, max_ticks=8_000,
               machine_speeds=(1.0, 0.7, 0.5), refine_freq=refine_freq,
               refine_theta_scale=theta_scale, migration_freeze=freeze)
    jcfg, pcfg = J.DESConfig(**cfg), P.DESConfig(**cfg)
    return adj, jcfg, pcfg, _states(jcfg, pcfg, spec, np.arange(n) % k)


def _schedules(mod):
    base = (1.0, 0.7, 0.5)
    return [mod.constant(3, base),
            mod.slowdown(3, machine=0, at_tick=90, factor=0.3,
                         recover_tick=300, base=base),
            mod.random_churn(3, num_segments=3, segment_ticks=120, seed=3,
                             low=0.3, high=1.0)]


def test_batch_equals_looped_and_reference_with_refine_theta_freeze():
    """Each element of the fleet is bitwise its own lone run (refinement
    through ``refine_batched`` against ``refine``), and the fleet is
    bitwise the reference's fleet."""
    adj, jcfg, pcfg, (js, ps) = _batch_fixture()
    p_scheds = _schedules(PS)
    stacked = PS.stack_schedules(p_scheds)
    adjs = torch.stack([torch.as_tensor(adj, dtype=torch.float32)] * 3)
    got = P.run_simulation_batch(pcfg, adjs, stack_pytrees([ps] * 3),
                                 stacked)
    for i, sched in enumerate(p_scheds):
        lone = P.run_simulation(pcfg, adj, ps, sched)
        assert bool(lone.done)
        for (name, a), (_, b) in zip(_fields(lone),
                                     _fields(unstack_pytree(got, i))):
            assert torch.equal(a, b), (i, name)
    want = J.run_simulation_batch(
        jcfg, jnp.stack([jnp.asarray(adj, jnp.float32)] * 3),
        j_stack([js] * 3), JS.stack_schedules(_schedules(JS)))
    _assert_same(want, got, "batch")


def test_plain_seams_reach_the_default_states():
    """The twins' 9-argument adapters (``make_aggregate_dissat_fn_plain``,
    what card checks hold the kernel paths against) give the states the
    default seams give, in a fleet and a lone run; ``_run_lone`` with
    eager ticks is ``run_simulation``."""
    from repro_torch.kernels.ops import make_aggregate_dissat_fn_plain
    smoke = _smoke()
    adj, _, pcfg, (_, ps) = _batch_fixture()
    p_scheds = _schedules(PS)
    stacked = PS.stack_schedules(p_scheds)
    adjs = torch.stack([torch.as_tensor(adj, dtype=torch.float32)] * 3)
    states = stack_pytrees([ps] * 3)
    twin3 = make_aggregate_dissat_fn_plain(batched=True)
    widths = []

    def seam(aggregate, *args, **kwargs):
        widths.append(aggregate.shape[0])
        return twin3(aggregate, *args, **kwargs)

    want = P.run_simulation_batch(pcfg, adjs, states, stacked)
    got = P.run_simulation_batch(pcfg, adjs, states, stacked, dissat_fn=seam)
    assert widths and int(want.refines.min()) > 0
    assert smoke.des_differ(want, got) == []
    lone = P.run_simulation(pcfg, adj, ps, p_scheds[1])
    assert smoke.des_differ(lone, P.run_simulation(
        pcfg, adj, ps, p_scheds[1],
        dissat_fn=make_aggregate_dissat_fn_plain())) == []
    assert smoke.des_differ(lone, P._run_lone(
        pcfg, adj, ps, p_scheds[1], None, graph_ticks=0)) == []


def test_batch_without_schedules_or_refinement():
    adj, _, pcfg, (_, ps) = _batch_fixture(refine_freq=0, theta_scale=0.0,
                                           freeze=0.0)
    adjs = torch.stack([torch.as_tensor(adj, dtype=torch.float32)] * 2)
    got = P.run_simulation_batch(pcfg, adjs, stack_pytrees([ps] * 2),
                                 None, chunk=64)
    lone = P.run_simulation(pcfg, adj, ps)
    assert bool(lone.done)
    for i in range(2):
        for (name, a), (_, b) in zip(_fields(lone),
                                     _fields(unstack_pytree(got, i))):
            assert torch.equal(a, b), (i, name)


def _coalesce_direct(ev, ann_pair, ann_time, ann_epoch):
    """The reference's (N, E, N) formulation of the announcement
    coalescing, in torch, as the oracle of the port's gather form."""
    bsz, n, e = ev.time.shape
    senders = torch.arange(n)
    rb_match = ((ev.valid & (ev.typ == P.ROLLBACK))[..., None]
                & (ev.sender[..., None] == senders)
                & (ev.count[..., None] == ann_epoch[:, None, None, :]))
    has_rb = rb_match.any(dim=2)                                # (B, R, S)
    slot_rb = rb_match.to(torch.int32).argmax(dim=2)            # (B, R, S)
    coalesce = ann_pair.transpose(1, 2) & has_rb
    upd = torch.where(coalesce, ann_time[:, None, :], P._INF)
    time = ev.time.scatter_reduce(2, slot_rb.long(), upd, "amin")
    return ev._replace(time=time), ann_pair & ~coalesce.transpose(1, 2)


@pytest.mark.parametrize("seed", range(6))
def test_coalesce_gather_form_equals_direct_form(seed):
    rng = np.random.default_rng(seed)
    bsz, n, e = 2, 7, 5
    ints = lambda lo, hi: torch.as_tensor(  # noqa: E731
        rng.integers(lo, hi, (bsz, n, e)).astype(np.int32))
    ev = P.EventLists(
        time=torch.as_tensor(rng.choice([1.0, 2.5, 4.0, P._INF],
                                        (bsz, n, e)).astype(np.float32)),
        thread=ints(-1, 3), typ=ints(0, 2), tick=ints(0, 3),
        count=ints(0, 3), sender=ints(-1, n), epoch=ints(0, 3),
        valid=torch.as_tensor(rng.random((bsz, n, e)) < 0.8))
    ann_pair = torch.as_tensor(rng.random((bsz, n, n)) < 0.5)
    ann_time = torch.as_tensor(rng.choice([0.5, 3.0, 9.0], (bsz, n))
                               .astype(np.float32))
    ann_epoch = torch.as_tensor(rng.integers(0, 3, (bsz, n)).astype(np.int32))
    got_ev, got_pairs = P._coalesce(ev, ann_pair, ann_time, ann_epoch)
    want_ev, want_pairs = _coalesce_direct(ev, ann_pair, ann_time, ann_epoch)
    assert torch.equal(got_ev.time, want_ev.time)
    assert torch.equal(got_pairs, want_pairs)
    assert bool((ann_pair & ~got_pairs).any())      # something coalesced


@pytest.mark.parametrize("seed", [0, 5])
def test_workload_equals_reference(seed):
    adj = preferential_attachment(40, seed=seed, m=2)
    kw = dict(num_threads=30, num_windows=3, scope=np.arange(30) % 4,
              max_per_lp=2)
    got, want = flooded_packet_workload(adj, seed, **kw), \
        j_workload(adj, seed, **kw)
    for field in ("src", "time", "count"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


SCHEDULES = [("constant", dict(speeds=[1.0, 0.5, 0.25])),
             ("slowdown", dict(machine=1, at_tick=50, factor=0.5,
                               recover_tick=120)),
             ("failure_recovery", dict(machine=0, fail_tick=10,
                                       recover_tick=90)),
             ("true_failure", dict(machine=2, fail_tick=0)),
             ("true_failure", dict(machine=2, fail_tick=30,
                                   recover_tick=60)),
             ("random_churn", dict(num_segments=5, segment_ticks=40,
                                   seed=9))]


def test_schedules_equal_reference():
    pairs = [_pair(name, 3, **kw) for name, kw in SCHEDULES]
    for want, got in pairs:
        np.testing.assert_array_equal(got.times.numpy(),
                                      np.asarray(want.times))
        np.testing.assert_array_equal(got.speeds.numpy(),
                                      np.asarray(want.speeds))
        for tick in (0, 9, 10, 49, 50, 119, 120, 5000):
            np.testing.assert_array_equal(
                PS.speeds_at(got, tick).numpy(),
                np.asarray(JS.speeds_at(want, jnp.int32(tick))))
            assert int(PS.segment_at(got, tick)) == \
                int(JS.segment_at(want, jnp.int32(tick)))
    j_stacked = JS.stack_schedules([w for w, _ in pairs])
    p_stacked = PS.stack_schedules([g for _, g in pairs])
    np.testing.assert_array_equal(p_stacked.times.numpy(),
                                  np.asarray(j_stacked.times))
    np.testing.assert_array_equal(p_stacked.speeds.numpy(),
                                  np.asarray(j_stacked.speeds))
    ticks = torch.tensor([0, 45, 80, 130, 200, 7])
    rows = PS.speeds_at(p_stacked, ticks)
    for b, (_, got) in enumerate(pairs):
        assert torch.equal(rows[b], PS.speeds_at(got, int(ticks[b])))


def test_schedule_errors():
    with pytest.raises(ValueError, match="start at tick 0"):
        PS.make_schedule([5], [[1.0]])
    with pytest.raises(ValueError, match="ascending"):
        PS.make_schedule([0, 0], [[1.0], [1.0]])
    with pytest.raises(ValueError, match="shape mismatch"):
        PS.make_schedule([0, 1], [[1.0]])
    with pytest.raises(ValueError):
        PS.pad_segments(PS.pad_segments(PS.constant(2), 3), 2)
    with pytest.raises(ValueError, match="machine count"):
        PS.stack_schedules([PS.constant(2), PS.constant(3)])
    with pytest.raises(ValueError):
        PS.stack_schedules([])
    with pytest.raises(ValueError):
        PS.random_churn(3, 0, 10, seed=0)


def test_unported_options_raise():
    adj, spec, jcfg, pcfg = _setup(16, 2, 4, 0, refine_freq=20)
    _, ps = _states(jcfg, pcfg, spec, np.arange(16) % 2)
    with pytest.raises(ValueError, match="single backend's seam"):
        P.run_simulation(dataclasses.replace(pcfg,
                                             refine_backend="distributed"),
                         adj, ps, dissat_fn=lambda *a: None)
    with pytest.raises(ValueError, match="refine_backend"):
        P.run_simulation(dataclasses.replace(pcfg, refine_backend="x"),
                         adj, ps)
    # telemetry is ported: each entry point takes its hooks and returns
    # the hook-free state
    from repro_torch.obs import Recorder
    rec = Recorder()
    small = dataclasses.replace(pcfg, max_ticks=40)
    out = P.run_simulation(small, adj, ps, recorder=rec)
    _assert_same(P.run_simulation(small, adj, ps), out)
    assert [e["kind"] for e in rec.events][-1] == "run_end"
    assert sum(e["kind"] == "tick" for e in rec.events) == \
        40 // pcfg.trace_stride
    fleet = P.run_simulation_batch(small, adj[None], stack_pytrees([ps]),
                                   recorder=rec)
    _assert_same(out, unstack_pytree(fleet, 0))
    assert sum(e["kind"] == "element" for e in rec.events) == 1
    rows = []
    s = ps
    for _ in range(pcfg.trace_stride):
        s = P.des_tick(pcfg, adj, s, emit_tick=lambda *r: rows.append(r))
    assert len(rows) == 1 and int(rows[0][0]) == pcfg.trace_stride
