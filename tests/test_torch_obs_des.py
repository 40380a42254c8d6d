"""The port's DES telemetry (``recorder=`` of ``run_simulation`` and
``run_simulation_batch``, ``des_tick``'s ``emit_tick``/``emit_refine``)
against the JAX reference's, event by event, on the CPU, at the size of
the reference's ``test_des_telemetry_bitwise_and_replay`` (20 LPs, 3
machines, 8 flood threads, refinement every 80 ticks with θ and the
migration freeze).  The budgets are ``test_torch_obs.py``'s; integer
fields (ticks, counters, segments, frozen LPs) are exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.batch import stack_pytrees as j_stack
from repro.des import engine as J
from repro.des.workload import flooded_packet_workload as j_workload
from repro.graphs.generators import preferential_attachment
from repro.obs import Recorder as JRecorder
from repro_torch.core.batch import stack_pytrees, unstack_pytree
from repro_torch.des import engine as P
from repro_torch.des.workload import flooded_packet_workload
from repro_torch.obs import Recorder

from test_torch_obs import _checked, _equal, assert_same_stream

torch.set_num_threads(1)


def _des_setup(refine_freq=80):
    n, k, threads = 20, 3, 8
    adj = preferential_attachment(n, 5, m=2)
    kw = dict(num_lps=n, num_machines=k, num_threads=threads,
              event_capacity=48, history_capacity=96, inter_delay=6,
              intra_delay=1, trace_stride=10, max_ticks=20_000,
              machine_speeds=(1.0, 0.7, 0.5), refine_freq=refine_freq,
              refine_theta_scale=5.0, migration_freeze=0.25)
    wl = dict(num_threads=threads, num_windows=2, scope=2,
              window_sim_time=40.0, max_per_lp=3)
    jspec = j_workload(adj, 9, **wl)
    pspec = flooded_packet_workload(adj, 9, **wl)
    jcfg, pcfg = J.DESConfig(**kw), P.DESConfig(**kw)
    m0 = np.arange(n) % k
    js = J.make_initial_state(jcfg, jnp.asarray(m0, jnp.int32), jspec.src,
                              jspec.time, jspec.count)
    ps = P.make_initial_state(pcfg, m0, pspec.src, pspec.time,
                              pspec.count, device="cpu")
    return adj, jcfg, pcfg, js, ps


@pytest.fixture(scope="module")
def des_runs():
    """The reference's recorded run, and the port's without and with a
    recorder — its tick-row buffer cut to 12 rows, so the run reads it
    back at many chunk borders."""
    adj, jcfg, pcfg, js, ps = _des_setup()
    want, got = JRecorder(), Recorder()
    J.run_simulation(jcfg, jnp.asarray(adj, jnp.float32), js, recorder=want)
    base = P.run_simulation(pcfg, adj, ps)
    out = P._run_lone(pcfg, adj, ps, None, None, P._GRAPH_TICKS,
                      recorder=got, tick_rows=12)
    return want.events, got.events, base, out


def test_des_stream_matches_reference(des_runs):
    """Tick rows on the cadence (the refinement ticks' rows carrying their
    round), one ``des_refine`` a round, the final counters — the rows
    read back at chunk borders losing none — and the recorder-free run's
    state bitwise."""
    want, got, base, out = des_runs
    _, _, pcfg, _, _ = _des_setup()
    assert _equal(base, out)
    assert_same_stream(want, got)
    ticks = [e for e in got if e["kind"] == "tick"]
    assert len(ticks) > 12
    assert ticks and all(e["t"] % pcfg.trace_stride == 0 for e in ticks)
    assert sum(e["kind"] == "des_refine" for e in got) == \
        int(out.refines) > 0
    _checked(got)


def test_des_tick_hooks_give_the_runs_rows(des_runs):
    """``des_tick``'s ``emit_tick``/``emit_refine`` hooks give the run's
    rows tick by tick, the refinement round at tick 80 included."""
    _, got, _, _ = des_runs
    adj, _, pcfg, _, ps = _des_setup()
    hooks = Recorder()
    s = ps
    for _ in range(100):
        s = P.des_tick(pcfg, adj, s, emit_tick=hooks._on_tick_row,
                       emit_refine=hooks._on_refine_row)
    hooks.record_des_rows("r0000")
    rows = [e for e in got if e["kind"] in ("tick", "des_refine")
            and e["t"] <= 100]
    assert hooks.events == rows
    assert any(e["kind"] == "des_refine" for e in rows)


def test_des_batch_stream_matches_reference(des_runs):
    """The fleet's ``element`` summaries are the reference's, and each
    element's state under a recorder is bitwise its lone recorder-free
    run (the fleet's contract)."""
    adj, jcfg, pcfg, js, ps = _des_setup()
    adjs = np.stack([adj, adj])
    want, got = JRecorder(), Recorder()
    J.run_simulation_batch(jcfg, jnp.asarray(adjs, jnp.float32),
                           j_stack([js, js]), recorder=want)
    out = P.run_simulation_batch(pcfg, adjs, stack_pytrees([ps, ps]),
                                 recorder=got)
    for b in range(2):
        assert _equal(unstack_pytree(out, b), des_runs[2])
    assert_same_stream(want.events, got.events)
    assert [e["batch"] for e in got.events if e["kind"] == "element"] \
        == [0, 1]


def test_des_stream_under_speed_churn_matches_reference():
    """Under a churn schedule each tick row's ``segment`` is the schedule
    segment in effect at the tick, and the backlog CV uses that
    segment's speeds."""
    from repro.des import scenarios as JS
    from repro_torch.des import scenarios as PS
    adj, jcfg, pcfg, js, ps = _des_setup()
    want, got = JRecorder(), Recorder()
    J.run_simulation(jcfg, jnp.asarray(adj, jnp.float32), js,
                     JS.random_churn(3, 6, 90, seed=4), recorder=want)
    P.run_simulation(pcfg, adj, ps, PS.random_churn(3, 6, 90, seed=4),
                     recorder=got)
    assert_same_stream(want.events, got.events)
    assert len({e["segment"] for e in got.events if e["kind"] == "tick"}) \
        > 1
    _checked(got.events)
