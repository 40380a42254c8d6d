"""The fleet's sweep modes and recompute path as one loop over the stack
(``repro_torch.core.batch``, DESIGN.md §12, §17), on the CPU.

``refine_simultaneous_batched``, ``refine_sweeps_batched`` and the
recompute path of ``refine_batched`` / ``refine_traced_batched`` run one
loop whose carry has a leading B axis, as the reference's one vmapped
program does.  Every element must stay BITWISE its looped run — result,
per-sweep potentials and activity, dtypes included — with elements that
stop at very different sweeps (one converged at sweep 0), coins drawn
from each element's own generator (whose final state must also be the
looped run's), and an unbounded sweep in which one element takes the
O(E·K) rebuild while another takes the mover buffer.  The loop runs
max_b sweeps_b sweeps, counted as reductions through the
``_assembled_dissat`` seam.  Against the reference's vmapped entry
points at ``move_prob = 1``: integers equal, potentials within its 1e-3
relative budget, on framework ct (its jnp reduction cycles on c, ROADMAP
queue 3, caveat 1).
"""
from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro_torch.core import batch
from repro_torch.core import refine as refine_mod
from repro_torch.core.refine import (refine, refine_simultaneous,
                                     refine_sweeps, refine_traced)

from test_torch_batch import K, _assert_element, _fleet, _j_stack, _theta

torch.set_num_threads(1)

B = 4
SWEEPS = 48

MODES = {
    "simultaneous": None,
    "degenerate": dict(moves_per_machine=1),
    "top2": dict(moves_per_machine=2),
    "unbounded": dict(moves_per_machine=None),
    "top2-coins": dict(moves_per_machine=2, move_prob=0.5, epsilon=1e-3),
    "unbounded-coins": dict(moves_per_machine=None, move_prob=0.5,
                            epsilon=1e-3),
}


def _converged_fleet(rep, framework, theta, seed0):
    """A fleet of B whose element 0 starts at an equilibrium of ``refine``
    (so it converges at sweep 0); the others from random starts."""
    jps, ports, r0s = _fleet(rep, B, seed0=seed0)
    th, ths = _theta(theta, B, ports[0].num_nodes)
    r0s[0] = refine(ports[0], r0s[0], framework, max_turns=5000,
                    theta=ths[0]).assignment.numpy()
    return jps, ports, r0s, th, ths


def _gens(kw):
    if kw is None or kw.get("move_prob", 1.0) >= 1.0:
        return None
    return [torch.Generator().manual_seed(7 + b) for b in range(B)]


def _run_fleet(mode, ports, r0s, framework, th, gens, max_sweeps=SWEEPS):
    stacked = batch.stack_problems(ports)
    kw = MODES[mode]
    if kw is None:
        return batch.refine_simultaneous_batched(
            stacked, np.stack(r0s), framework, max_sweeps=max_sweeps,
            theta=th)
    return batch.refine_sweeps_batched(
        stacked, np.stack(r0s), framework, max_sweeps=max_sweeps, theta=th,
        generators=gens, **kw)


def _run_lone(mode, port, r0, framework, theta, gen, max_sweeps=SWEEPS):
    kw = MODES[mode]
    if kw is None:
        return refine_simultaneous(port, r0, framework,
                                   max_sweeps=max_sweeps, theta=theta)
    return refine_sweeps(port, r0, framework, max_sweeps=max_sweeps,
                         theta=theta, generator=gen, **kw)


@pytest.mark.parametrize("theta", [None, "per-node"])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_sweep_fleet_is_bitwise_its_looped_runs(rep, mode, framework,
                                                theta):
    """Every element == its lone run bitwise, in every sweep mode; the
    elements stop at different sweeps, element 0 at sweep 0; with coins,
    each generator ends in its looped run's state."""
    _, ports, r0s, th, ths = _converged_fleet(rep, framework, theta,
                                              seed0=110)
    gens = _gens(MODES[mode])
    out_b = _run_fleet(mode, ports, r0s, framework, th, gens)
    for b in range(B):
        gen = None if gens is None else torch.Generator().manual_seed(7 + b)
        out_l = _run_lone(mode, ports[b], r0s[b], framework, ths[b], gen)
        _assert_element(out_l, out_b, b, f"{mode}[{rep},{framework}]")
        if gens is not None:
            assert torch.equal(gens[b].get_state(), gen.get_state()), b
    turns = out_b[0].num_turns.tolist()
    assert turns[0] == 0 < min(turns[1:]) and bool(out_b[0].converged[0])
    if bool(out_b[0].converged.all()):
        assert len(set(turns)) > 2, turns
    assert out_b[1][2].shape == (B, SWEEPS)


@pytest.mark.parametrize("mode", ["unbounded", "unbounded-coins"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_unbounded_rebuild_and_buffer_in_one_sweep(rep, mode, monkeypatch):
    """With the mover buffer's cap lowered, a sweep in which one element
    rebuilds (count > cap) while another goes through the buffer stays
    bitwise the looped runs under the same cap."""
    _, ports, r0s, th, ths = _converged_fleet(rep, "c", None, seed0=130)
    seen = []
    apply = batch._apply_unbounded

    def spy(*args):
        bound = inspect.signature(apply).bind(*args).arguments
        seen.append(sorted(bound["counts"][b] for b in bound["doing"]))
        return apply(*args)

    monkeypatch.setattr(batch, "_apply_unbounded", spy)
    _run_fleet(mode, ports, r0s, "c", th, _gens(MODES[mode]))
    first = [c for c in seen if len(c) > 1][0]
    cap = (first[0] + first[-1]) // 2          # splits the first sweep
    assert first[0] <= cap < first[-1]
    monkeypatch.setattr(refine_mod, "_UNBOUNDED_APPLY_CAP", cap)
    seen.clear()
    gens = _gens(MODES[mode])
    out_b = _run_fleet(mode, ports, r0s, "c", th, gens)
    assert any(c[0] <= cap < c[-1] for c in seen)
    for b in range(B):
        gen = None if gens is None else torch.Generator().manual_seed(7 + b)
        out_l = _run_lone(mode, ports[b], r0s[b], "c", ths[b], gen)
        _assert_element(out_l, out_b, b, f"cap {cap} [{rep}]")


@pytest.mark.parametrize("mode", ["simultaneous", "top2-coins",
                                  "unbounded-coins"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_fleet_runs_max_not_sum_of_sweeps(rep, mode, monkeypatch):
    """The one loop reduces the stack max_b sweeps_b times (its longest
    element's reductions), where the looped runs reduce Σ_b sweeps_b."""
    _, ports, r0s, th, ths = _converged_fleet(rep, "ct", None, seed0=150)
    calls = []
    assembled = refine_mod._assembled_dissat

    def counted(aggregate, *args):
        calls.append(aggregate.shape)
        return assembled(aggregate, *args)

    monkeypatch.setattr(refine_mod, "_assembled_dissat", counted)
    gens = _gens(MODES[mode])
    lone = []
    for b in range(B):
        gen = None if gens is None else torch.Generator().manual_seed(7 + b)
        calls.clear()
        _run_lone(mode, ports[b], r0s[b], "ct", ths[b], gen)
        lone.append(len(calls))
    calls.clear()
    _run_fleet(mode, ports, r0s, "ct", th, gens)
    assert all(len(shape) == 3 and shape[0] == B for shape in calls)
    assert len(calls) == max(lone) < sum(lone), (len(calls), lone)


@pytest.mark.parametrize("theta", [None, "per-node"])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_recompute_path_is_one_loop_bitwise(rep, framework, theta):
    """``incremental=False``: every element of ``refine_batched`` and
    ``refine_traced_batched`` == its unbatched recompute run bitwise,
    elements converging on different turns."""
    _, ports, r0s, th, ths = _converged_fleet(rep, framework, theta,
                                              seed0=170)
    stacked = batch.stack_problems(ports)
    res_b = batch.refine_batched(stacked, np.stack(r0s), framework,
                                 max_turns=2000, incremental=False, theta=th)
    tr_b = batch.refine_traced_batched(stacked, np.stack(r0s), framework,
                                       max_turns=40, incremental=False,
                                       theta=th)
    for b in range(B):
        _assert_element(refine(ports[b], r0s[b], framework, max_turns=2000,
                               incremental=False, theta=ths[b]),
                        res_b, b, "recompute")
        _assert_element(refine_traced(ports[b], r0s[b], framework,
                                      max_turns=40, incremental=False,
                                      theta=ths[b]), tr_b, b,
                        "traced recompute")
    assert bool(res_b.converged.all())
    assert len(set(res_b.num_turns.tolist())) > 2


def test_recompute_path_recomputes_only_live_elements(monkeypatch):
    """An element the host has seen converged at a ``_SYNC_EVERY`` read
    builds no more aggregates: element b builds one a turn up to the first
    read after its last active turn, and the result is unchanged."""
    _, ports, r0s, _, _ = _converged_fleet("dense", "c", None, seed0=170)
    built = []
    aggregate = batch.costs.problem_aggregate

    def counted(*args):
        built.append(1)
        return aggregate(*args)

    sync = 8
    monkeypatch.setattr(batch, "_SYNC_EVERY", sync)
    monkeypatch.setattr(batch.costs, "problem_aggregate", counted)
    res = batch.refine_batched(batch.stack_problems(ports), np.stack(r0s),
                               "c", max_turns=2000, incremental=False)
    turns = res.num_turns.tolist()
    assert turns[0] == K and int(res.num_moves[0]) == 0   # K idle turns
    assert len(built) == sum(-(-t // sync) * sync for t in turns), turns
    assert len(built) < B * max(turns)
    monkeypatch.undo()
    for b in range(B):
        _assert_element(refine(ports[b], r0s[b], "c", max_turns=2000,
                               incremental=False), res, b, "live")


# ---------------------------------------------------------------------------
# against the reference's vmapped entry points, move_prob = 1
# ---------------------------------------------------------------------------

REF_CASES = [("dense", "simultaneous", None), ("sparse", "simultaneous", 0.5),
             ("dense", "top2", None), ("sparse", "top2", 0.5),
             ("sparse", "unbounded", None),
             ("dense", "epsilon", 0.5)]


@pytest.mark.parametrize("rep,mode,theta", REF_CASES)
def test_sweep_fleet_matches_reference_vmapped(rep, mode, theta):
    """Each element's moves, sweeps, activity, convergence and assignment
    equal the reference's vmapped run; the per-sweep potentials are within
    1e-3 relative."""
    jps, ports, r0s = _fleet(rep, 3, seed0=190)
    jst, jr0 = _j_stack(jps, r0s)
    stacked = batch.stack_problems(ports)
    if mode == "simultaneous":
        want = jbatch.refine_simultaneous_batched(jst, jr0, "ct",
                                                  max_sweeps=SWEEPS,
                                                  theta=theta)
        got = batch.refine_simultaneous_batched(stacked, np.stack(r0s), "ct",
                                                max_sweeps=SWEEPS,
                                                theta=theta)
    else:
        kw = {"top2": dict(moves_per_machine=2),
              "unbounded": dict(moves_per_machine=None),
              "epsilon": dict(moves_per_machine=1, epsilon=1e-3)}[mode]
        want = jbatch.refine_sweeps_batched(jst, jr0, "ct", max_sweeps=SWEEPS,
                                            theta=theta, **kw)
        got = batch.refine_sweeps_batched(stacked, np.stack(r0s), "ct",
                                          max_sweeps=SWEEPS, theta=theta,
                                          **kw)
    (gres, (gc0, gct0, gact)), (wres, (wc0, wct0, wact)) = got, want
    for field in ("assignment", "num_moves", "num_turns", "converged"):
        np.testing.assert_array_equal(getattr(gres, field).numpy(),
                                      np.asarray(getattr(wres, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(gact.numpy(), np.asarray(wact))
    np.testing.assert_allclose(gc0.numpy(), np.asarray(wc0), rtol=1e-3)
    np.testing.assert_allclose(gct0.numpy(), np.asarray(wct0), rtol=1e-3)
    assert int(gres.num_moves.sum()) > 0
