"""The port's run telemetry (``repro_torch.obs`` and every runtime's
``recorder=``) against the JAX reference's, event by event, on the CPU.

For the same numpy-seeded inputs each port runtime emits the reference's
event stream: the same kinds in the same order, integers, booleans and
strings exactly equal, floats within the reference's own budgets —
carried potentials (``c0``/``ct0``) and every other float within 1e-5
relative (1e-6 absolute near zero), loads within ``check_run``'s rtol
1e-5 / atol 1e-3, a turn's gains (differences of costs) within the
reference's kernel-vs-jnp budget for dissatisfaction, rtol 2e-4 / atol
2e-2.  ``phase`` timings (``ts``, ``dur``) and ``wall`` are
left out.  On framework c the reference's jnp refine cycles (ROADMAP
queue 3, caveat 1), so ``refine`` on c is held to the reference's kernel
path (the Pallas kernel in interpret mode); the other runtimes run on ct.

Also: replay + ``check_run`` on port logs; each package's report CLI
``--check`` on the other's logs; the JSONL round trip, the Chrome trace
and the sink fan-out; ``run_aborted`` on a run that raises; the timed
``dissat_fn``; and the ``recorder=None`` contract — the aten operations
that ``refine``, ``refine_sweeps`` and one DES chunk dispatch without a
recorder, counted under a ``TorchDispatchMode``, equal the counts pinned
from the tree before telemetry was ported.
"""
from __future__ import annotations

import importlib
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import repro.distributed as JD
import repro.sweeps as jsweeps
from repro.core.problem import make_problem as j_make_problem
from repro.distributed import faults as JF
from repro.graphs.generators import random_degree_graph, random_weights
from repro.kernels.ops import make_aggregate_dissat_fn as j_kernel_fn
from repro.obs import JsonlSink as JJsonlSink
from repro.obs import Recorder as JRecorder
from repro.obs import report as j_report
from repro_torch import distributed as PD
from repro_torch import sweeps
from repro_torch.core.problem import problem_from_arrays
from repro_torch.core.refine import (refine, refine_simultaneous,
                                     refine_sweeps, refine_traced)
from repro_torch.des import engine as P
from repro_torch.des.workload import flooded_packet_workload
from repro_torch.distributed import faults as PF
from repro_torch.kernels import ops
from repro_torch.obs import (EVENT_KINDS, JsonlSink, MemorySink, Recorder,
                             chrome_trace, make_event, read_jsonl,
                             validate_event)
from repro_torch.obs import report as p_report
from repro_torch.obs.report import check_run, replay_run

# the module: ``repro.core``'s package namespace binds ``refine`` to the
# function
JR = importlib.import_module("repro.core.refine")

torch.set_num_threads(1)

N, K = 48, 4
REL = 1e-5              # potentials and other floats, relative
ABS = 1e-6              # ... and absolute, for values near zero
LOAD_RTOL, LOAD_ATOL = 1e-5, 1e-3    # check_run's budget for loads
# a turn's (net or raw) best gain is a dissatisfaction value: a difference
# of costs, held to the reference's budget between its kernel and its jnp
# reduction (rtol 2e-4, atol 2e-2, ``tests/test_kernels.py``)
GAIN_RTOL, GAIN_ATOL = 2e-4, 2e-2
UNTIMED = ("ts", "dur", "wall")


@pytest.fixture(scope="module")
def instance():
    """(reference problem, port problem, r0) on identical bits."""
    adj = random_degree_graph(N, seed=3)
    b, c = random_weights(adj, seed=4, mean=5.0)
    jp = j_make_problem(c, b, np.ones(K) / K, mu=8.0)
    pp = problem_from_arrays(np.asarray(jp.adjacency),
                             np.asarray(jp.node_weights),
                             np.asarray(jp.speeds), np.asarray(jp.mu),
                             device="cpu")
    r0 = np.random.default_rng(5).integers(0, K, N).astype(np.int32)
    return jp, pp, r0


def _same_value(key, want, got, where):
    if isinstance(want, bool) or isinstance(got, bool):
        assert want == got, where
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), where
        if key in ("loads",):
            np.testing.assert_allclose(got, want, rtol=LOAD_RTOL,
                                       atol=LOAD_ATOL, err_msg=where)
        else:
            for w, g in zip(want, got):
                _same_value(key, w, g, where)
    elif isinstance(want, float) or isinstance(got, float):
        assert isinstance(want, (int, float)) and \
            isinstance(got, (int, float)), where
        gain = key in ("gain", "raw_gain")
        if np.isnan(want):
            assert np.isnan(got), where
        else:
            np.testing.assert_allclose(
                got, want, rtol=GAIN_RTOL if gain else REL,
                atol=GAIN_ATOL if gain else ABS, err_msg=where)
    else:
        assert want == got, where


def assert_same_stream(want: list[dict], got: list[dict]) -> None:
    """The port's events are the reference's: kinds in order, the same
    keys, exact integers/bools/strings, floats within budget; timings
    left out."""
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    for i, (w, g) in enumerate(zip(want, got)):
        keys = set(w) - set(UNTIMED)
        assert set(g) - set(UNTIMED) == keys, (i, w, g)
        for key in keys:
            _same_value(key, w[key], g[key], f"event {i} {w['kind']}.{key}:"
                        f" {w[key]!r} vs {g[key]!r}")


def _equal(a, b) -> bool:
    """Every tensor leaf of two (nested) results equal bitwise."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _problems(report, events) -> list[str]:
    """A log's ``check_run`` findings, run by run, up to their numbers."""
    return [p.split("(")[0] for run in report.split_runs(events).values()
            for p in report.check_run(report.replay_run(run))]


def _checked(got, want=None):
    """``check_run`` passes the port's log — or, given the reference's log
    of the same run, finds the same: on ct the sequential runtimes'
    carried C_0 may ascend (the game descends Ct_0), which the
    reference's check reports on its own logs too."""
    found = _problems(p_report, got)
    if want is None:
        assert found == []
    else:
        assert found == _problems(j_report, want)


# ---------------------------------------------------------------------------
# the copied modules
# ---------------------------------------------------------------------------

def test_event_schema_is_the_references():
    from repro.obs import EVENT_KINDS as J_KINDS
    assert EVENT_KINDS == J_KINDS
    event = make_event("turn", "r0000", t=0, moved=True, c0=1.0, ct0=2.0,
                       node=torch.tensor(3), gain=np.float32(0.5))
    assert validate_event(event)["node"] == 3
    json.dumps(event)
    with pytest.raises(ValueError):
        make_event("turn", "r0000", t=0)
    with pytest.raises(ValueError):
        validate_event({"kind": "nope", "run": "r0000"})


def test_memory_sink_fanout_jsonl_and_chrome_trace(instance, tmp_path):
    _, pp, r0 = instance
    log = tmp_path / "run.jsonl"
    sinks = [MemorySink(), MemorySink(), JsonlSink(log)]
    rec = Recorder(sinks)
    refine(pp, torch.as_tensor(r0), "ct", max_turns=500, recorder=rec)
    rec.close()
    assert sinks[0].events == sinks[1].events == rec.events
    assert read_jsonl(log) == rec.events
    trace = chrome_trace(rec.events)
    slices = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in slices] == ["core.refine"]
    assert slices[0]["dur"] >= 0
    out = tmp_path / "trace.json"
    assert p_report.main([str(log), "--trace", str(out)]) == 0
    assert json.loads(out.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# core entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["c-kernel", "ct", "ct-theta",
                                  "ct-recompute"])
def test_refine_stream_matches_reference(instance, case):
    jp, pp, r0 = instance
    fw = case.split("-")[0]
    kw = dict(max_turns=500)
    jkw = dict(kw)
    if case == "c-kernel":
        jkw["dissat_fn"] = j_kernel_fn(interpret=True)
    if case == "ct-theta":
        kw["theta"] = jkw["theta"] = 400.0
    if case == "ct-recompute":
        kw["incremental"] = jkw["incremental"] = False
    want, got = JRecorder(), Recorder()
    JR.refine(jp, jnp.asarray(r0), fw, recorder=want, **jkw)
    base = refine(pp, torch.as_tensor(r0), fw, **kw)
    res = refine(pp, torch.as_tensor(r0), fw, recorder=got, **kw)
    assert _equal(base, res)
    assert_same_stream(want.events, got.events)
    turns = [e for e in got.events if e["kind"] == "turn"]
    assert len(turns) == int(res.num_turns)
    if case == "ct-theta":
        assert {e["reject"] for e in turns} >= {"hysteresis", None}
    _checked(got.events, want.events)
    if fw == "c":
        _checked(got.events)


@pytest.mark.parametrize("case", ["ct", "ct-theta", "ct-recompute"])
def test_refine_traced_stream_matches_reference(instance, case):
    jp, pp, r0 = instance
    kw = dict(max_turns=96)
    if case == "ct-theta":
        kw["theta"] = 400.0
    if case == "ct-recompute":
        kw["incremental"] = False
    want, got = JRecorder(), Recorder()
    JR.refine_traced(jp, jnp.asarray(r0), "ct", recorder=want, **kw)
    base = refine_traced(pp, torch.as_tensor(r0), "ct", **kw)
    out = refine_traced(pp, torch.as_tensor(r0), "ct", recorder=got, **kw)
    assert _equal(base, out)
    assert_same_stream(want.events, got.events)
    _checked(got.events, want.events)


@pytest.mark.parametrize("entry", ["simultaneous", "sweeps-1", "sweeps-2"])
def test_sweep_streams_match_reference(instance, entry):
    jp, pp, r0 = instance
    if entry == "simultaneous":
        jfn, pfn, kw = JR.refine_simultaneous, refine_simultaneous, {}
    else:
        jfn, pfn = JR.refine_sweeps, refine_sweeps
        kw = dict(moves_per_machine=int(entry[-1]))
    kw["max_sweeps"] = 16
    want, got = JRecorder(), Recorder()
    jfn(jp, jnp.asarray(r0), "ct", recorder=want, **kw)
    base = pfn(pp, torch.as_tensor(r0), "ct", **kw)
    out = pfn(pp, torch.as_tensor(r0), "ct", recorder=got, **kw)
    assert _equal(base, out)
    assert_same_stream(want.events, got.events)
    runtime = "refine_simultaneous" if entry == "simultaneous" \
        else "refine_sweeps"
    assert got.events[0]["runtime"] == runtime
    assert [e["name"] for e in got.events if e["kind"] == "phase"] == \
        [f"core.{runtime}"]
    _checked(got.events, want.events)


def test_run_sweep_traced_stream_matches_reference(instance):
    jp, pp, r0 = instance
    jcases = [jsweeps.SweepCase(problem=jp, assignment=jnp.asarray(r0),
                                framework="ct", label=str(t), theta=t)
              for t in (None, None)]
    pcases = [sweeps.SweepCase(problem=pp, assignment=r0, framework="ct",
                               label=str(t), theta=t) for t in (None, None)]
    want, got = JRecorder(), Recorder()
    jsweeps.run_sweep(jsweeps.make_spec(jcases, mode="traced", max_turns=64),
                      recorder=want)
    spec = sweeps.make_spec(pcases, mode="traced", max_turns=64)
    base = sweeps.run_sweep(spec)
    out = sweeps.run_sweep(spec, recorder=got)
    for a, b in zip(base.results + base.traces, out.results + out.traces):
        assert _equal(a, b)
    assert_same_stream(want.events, got.events)
    assert [e["batch"] for e in got.events if e["kind"] == "element"] \
        == [0, 1]
    _checked(got.events)


# ---------------------------------------------------------------------------
# distributed drivers and faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["plain", "traced", "sweep"])
def test_distributed_streams_match_reference(instance, driver):
    jp, pp, r0 = instance
    jfn, pfn, kw = {
        "plain": (JD.refine_distributed, PD.refine_distributed,
                  dict(max_turns=500)),
        "traced": (JD.refine_distributed_traced,
                   PD.refine_distributed_traced, dict(max_turns=96)),
        "sweep": (JD.refine_distributed_simultaneous,
                  PD.refine_distributed_simultaneous, dict(max_sweeps=16)),
    }[driver]
    want, got = JRecorder(), Recorder()
    jfn(jp, jnp.asarray(r0), "ct", num_shards=K, recorder=want, **kw)
    base = pfn(pp, torch.as_tensor(r0), "ct", num_shards=K, **kw)
    out = pfn(pp, torch.as_tensor(r0), "ct", num_shards=K, recorder=got,
              **kw)
    assert _equal(base, out)
    assert_same_stream(want.events, got.events)
    wire = [e for e in got.events if e["kind"] == "wire"]
    assert len(wire) == 1 and wire[0]["ok"]
    assert wire[0]["measured_payload"] == wire[0]["predicted_payload"]
    _checked(got.events, want.events)


def test_shard_map_stream_on_a_group_of_one(instance):
    """The collective driver (a gloo group of one) records what the
    reference's one-device ``shard_map`` driver records."""
    jp, pp, r0 = instance
    want, got = JRecorder(), Recorder()
    JD.refine_distributed_shard_map(jp, jnp.asarray(r0), "ct",
                                    num_shards=1, max_turns=500,
                                    recorder=want)
    base = PD.refine_distributed_shard_map(pp, torch.as_tensor(r0), "ct",
                                           num_shards=1, max_turns=500)
    out = PD.refine_distributed_shard_map(pp, torch.as_tensor(r0), "ct",
                                          num_shards=1, max_turns=500,
                                          recorder=got)
    assert _equal(base, out)
    assert_same_stream(want.events, got.events)
    _checked(got.events, want.events)


MIXED = dict(p_down=0.03, down_length=(2, 4), p_omit=0.05, p_lost=0.2,
             p_dup=0.08, p_corrupt=0.04, num_machines=K, num_nodes=N)


@pytest.mark.parametrize("mode", ["plain", "traced"])
def test_faulty_stream_matches_reference(instance, mode):
    jp, pp, r0 = instance
    jplan = JF.make_fault_plan(96, K, 0, **MIXED)
    pplan = PF.make_fault_plan(96, K, 0, **MIXED)
    jfn, pfn = ((JD.refine_distributed, PD.refine_distributed)
                if mode == "plain" else
                (JD.refine_distributed_traced, PD.refine_distributed_traced))
    want, got = JRecorder(), Recorder()
    jfn(jp, jnp.asarray(r0), "ct", num_shards=K, max_turns=500,
        fault_plan=jplan, recorder=want)
    base = pfn(pp, torch.as_tensor(r0), "ct", num_shards=K, max_turns=500,
               fault_plan=pplan)
    out = pfn(pp, torch.as_tensor(r0), "ct", num_shards=K, max_turns=500,
              fault_plan=pplan, recorder=got)
    assert _equal(base[:-1], out[:-1]) and base[-1] == out[-1]
    assert_same_stream(want.events, got.events)
    kinds = {e["kind"] for e in got.events}
    assert {"fault_injected", "exchange_retry", "repair"} <= kinds
    assert got.events[-1]["recovered"] is True
    _checked(got.events)


@pytest.mark.parametrize("side", [False, True])
def test_emit_fault_events_matches_reference(side):
    jplan = JF.make_fault_plan(96, K, 1, **MIXED)
    pplan = PF.make_fault_plan(96, K, 1, **MIXED)
    kw = {}
    if side:
        rng = np.random.default_rng(0)
        kw = dict(repair_drift=rng.uniform(0, 1, 96).astype(np.float32),
                  repaired_cols=rng.integers(0, K, 96).astype(np.int32),
                  repaired=rng.uniform(size=96) < 0.5)
    want, got = JRecorder(), Recorder()
    JF.emit_fault_events(want, "r0000", jplan, 90,
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    PF.emit_fault_events(got, "r0000", pplan, 90,
                         **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert got.events and got.events == want.events


# ---------------------------------------------------------------------------
# logs across packages, aborts, the timed dissat_fn
# ---------------------------------------------------------------------------

def test_each_report_cli_checks_the_others_logs(instance, tmp_path, capsys):
    jp, pp, r0 = instance
    port_log, ref_log = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    rec = Recorder([JsonlSink(port_log)])
    refine(pp, torch.as_tensor(r0), "c", max_turns=500, recorder=rec)
    PD.refine_distributed(pp, torch.as_tensor(r0), "c", num_shards=K,
                          max_turns=500, recorder=rec)
    rec.close()
    jrec = JRecorder([JJsonlSink(ref_log)])
    JR.refine(jp, jnp.asarray(r0), "c", max_turns=500,
              dissat_fn=j_kernel_fn(interpret=True), recorder=jrec)
    jrec.close()
    assert j_report.main([str(port_log), "--check"]) == 0
    assert "wire [OK]" in capsys.readouterr().out
    assert p_report.main([str(ref_log), "--check"]) == 0
    assert p_report.main([str(port_log), str(ref_log), "--check"]) == 0
    out = capsys.readouterr().out
    assert "run port:r0000" in out and "run ref:r0000" in out
    assert p_report.main([str(port_log), "--json"]) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        json.loads(line)


def test_run_aborted_is_flushed_when_a_run_raises(instance, tmp_path):
    """A ``dissat_fn`` failing mid-run: the phase still closes, a terminal
    ``run_aborted`` reaches the sink on disk, and ``--check`` fails."""
    _, pp, r0 = instance
    log = tmp_path / "abort.jsonl"
    rec = Recorder([JsonlSink(log)])
    inner = ops.make_aggregate_dissat_fn()
    calls = []

    def failing(*args):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("device lost mid-run")
        return inner(*args)

    with pytest.raises(RuntimeError, match="device lost"):
        refine(pp, torch.as_tensor(r0), "ct", max_turns=500,
               dissat_fn=failing, recorder=rec)
    events = read_jsonl(log)            # flushed, not yet closed
    assert [e["kind"] for e in events] == ["run_start", "phase",
                                           "run_aborted"]
    assert "device lost" in events[-1]["error"]
    assert any("aborted" in p for p in check_run(replay_run(events)))
    assert p_report.main([str(log), "--check"]) == 1
    rec.close()


def test_timed_dissat_fn_is_the_unwrapped_function(instance):
    _, pp, r0 = instance
    rec = Recorder()
    plain = ops.make_aggregate_dissat_fn()
    timed = ops.make_timed_dissat_fn(plain, rec, name="unit.dissat")
    base = refine(pp, torch.as_tensor(r0), "ct", max_turns=500,
                  dissat_fn=plain)
    res = refine(pp, torch.as_tensor(r0), "ct", max_turns=500,
                 dissat_fn=timed)
    assert _equal(base, res)
    spans = [e for e in rec.events if e["kind"] == "phase"]
    assert spans and all(e["name"] == "unit.dissat" and e["dur"] >= 0
                         for e in spans)
    # one span a reduction: every loop turn, masked tail included
    loop_turns = -(-int(res.num_turns) // 64) * 64
    assert len(spans) == min(loop_turns, 500)


# ---------------------------------------------------------------------------
# recorder=None: the operations dispatched are the pre-telemetry ones
# ---------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _count_ops(fn) -> dict:
    with _CountOps() as mode:
        fn()
    return dict(mode.ops)


# Counted on the tree before telemetry was ported (torch 2.13.0+cpu).
PINNED_OPS = {
    "refine": {
        "aten._local_scalar_dense.default": 1, "aten._to_copy.default": 845,
        "aten.add.Tensor": 1285, "aten.arange.default": 326,
        "aten.argmax.default": 64, "aten.bitwise_and.Tensor": 64,
        "aten.clamp.default": 64, "aten.div.Tensor": 66, "aten.eq.Scalar": 64,
        "aten.eq.Tensor": 390, "aten.expand.default": 128,
        "aten.full.default": 64, "aten.gather.default": 641,
        "aten.ge.Scalar": 1, "aten.gt.Scalar": 64, "aten.le.Tensor": 64,
        "aten.lt.Scalar": 65, "aten.min.dim": 128, "aten.mm.default": 5,
        "aten.mul.Tensor": 1673, "aten.ne.Tensor": 1,
        "aten.new_full.default": 64, "aten.reciprocal.default": 128,
        "aten.scalar_tensor.default": 576, "aten.scatter.src": 64,
        "aten.select.int": 257, "aten.slice.Tensor": 772,
        "aten.squeeze_.dim": 3, "aten.sub.Tensor": 707, "aten.sum.default": 6,
        "aten.sum.dim_IntList": 64, "aten.unsqueeze.default": 1552,
        "aten.view.default": 320, "aten.where.self": 768,
        "aten.zeros.default": 4
    },
    "refine_sweeps": {
        "aten._local_scalar_dense.default": 10, "aten._to_copy.default": 146,
        "aten.add.Tensor": 135, "aten.any.default": 10,
        "aten.arange.default": 54, "aten.argmax.default": 10,
        "aten.cat.default": 9, "aten.div.Tensor": 30, "aten.eq.Tensor": 53,
        "aten.gather.default": 20, "aten.gt.Scalar": 10,
        "aten.index_put_.default": 9, "aten.index_select.default": 19,
        "aten.le.Tensor": 10, "aten.lift_fresh.default": 2, "aten.max.dim": 10,
        "aten.min.dim": 20, "aten.mm.default": 23, "aten.mul.Tensor": 157,
        "aten.ne.Tensor": 1, "aten.new_zeros.default": 9,
        "aten.scalar_tensor.default": 29, "aten.select.int": 65,
        "aten.slice.Tensor": 125, "aten.squeeze_.dim": 21,
        "aten.stack.default": 2, "aten.sub.Tensor": 69, "aten.sum.default": 53,
        "aten.unsqueeze.default": 224, "aten.where.self": 29,
        "aten.zeros.default": 2
    },
    "des_chunk": {
        "aten._local_scalar_dense.default": 3, "aten._to_copy.default": 3093,
        "aten.add.Tensor": 2220, "aten.any.default": 3, "aten.any.dim": 400,
        "aten.arange.default": 1126, "aten.argmax.default": 64,
        "aten.bitwise_and.Tensor": 5513, "aten.bitwise_not.default": 1845,
        "aten.bitwise_or.Tensor": 641, "aten.cat.default": 80,
        "aten.ceil.default": 80, "aten.clamp.default": 1185,
        "aten.clone.default": 81, "aten.cumsum.default": 80,
        "aten.div.Tensor": 307, "aten.eq.Scalar": 785, "aten.eq.Tensor": 1110,
        "aten.expand.default": 1090, "aten.full.default": 305,
        "aten.gather.default": 4161, "aten.ge.Scalar": 561,
        "aten.ge.Tensor": 400, "aten.gt.Scalar": 387, "aten.gt.Tensor": 160,
        "aten.le.Scalar": 160, "aten.le.Tensor": 384,
        "aten.lift_fresh.default": 2, "aten.lt.Scalar": 708,
        "aten.lt.Tensor": 320, "aten.max.dim": 80, "aten.min.dim": 928,
        "aten.minimum.default": 560, "aten.mm.default": 5,
        "aten.mul.Tensor": 1917, "aten.ne.Tensor": 83,
        "aten.new_full.default": 64, "aten.ones_like.default": 160,
        "aten.reciprocal.default": 128, "aten.remainder.Scalar": 81,
        "aten.round.default": 1, "aten.rsub.Scalar": 80,
        "aten.scalar_tensor.default": 2739, "aten.scatter.src": 1504,
        "aten.scatter_.value": 160, "aten.scatter_reduce_.two": 240,
        "aten.searchsorted.Tensor": 80, "aten.select.int": 1581,
        "aten.slice.Tensor": 982, "aten.sort.stable": 80,
        "aten.squeeze_.dim": 3, "aten.stack.default": 38,
        "aten.sub.Tensor": 1252, "aten.sum.default": 6,
        "aten.sum.dim_IntList": 711, "aten.transpose.int": 400,
        "aten.unsqueeze.default": 6676, "aten.view.default": 4880,
        "aten.where.self": 8614, "aten.zeros.default": 164
    },
}


def _ops_instance():
    """The instance the counts were pinned on (port generators)."""
    from repro_torch.core.problem import make_problem
    from repro_torch.graphs.generators import (
        preferential_attachment as p_pa, random_degree_graph as p_rdg,
        random_weights as p_rw)
    adj = p_rdg(N, seed=3)
    b, c = p_rw(adj, seed=4, mean=5.0)
    prob = make_problem(c, b, np.ones(K) / K, mu=8.0, device="cpu")
    r0 = torch.as_tensor(np.random.default_rng(5).integers(0, K, N),
                         dtype=torch.int32)
    n, k, threads = 20, 3, 8
    a = p_pa(n, 5, m=2)
    spec = flooded_packet_workload(a, 9, num_threads=threads, num_windows=2,
                                   scope=2, window_sim_time=40.0,
                                   max_per_lp=3)
    cfg = P.DESConfig(num_lps=n, num_machines=k, num_threads=threads,
                      event_capacity=48, history_capacity=96, inter_delay=6,
                      intra_delay=1, trace_stride=10, max_ticks=80,
                      machine_speeds=(1.0, 0.7, 0.5), refine_freq=80,
                      refine_theta_scale=5.0, migration_freeze=0.25)
    s0 = P.make_initial_state(cfg, np.arange(n) % k, spec.src, spec.time,
                              spec.count, device="cpu")
    return prob, r0, cfg, a, s0


@pytest.mark.parametrize("entry", ["refine", "refine_sweeps", "des_chunk"])
def test_recorder_free_paths_dispatch_the_pinned_ops(entry):
    prob, r0, cfg, adj, s0 = _ops_instance()
    run = {"refine": lambda: refine(prob, r0, "c", max_turns=500),
           "refine_sweeps": lambda: refine_sweeps(prob, r0, "c",
                                                  max_sweeps=16),
           "des_chunk": lambda: P.run_simulation(cfg, adj, s0)}[entry]
    assert _count_ops(run) == PINNED_OPS[entry]
