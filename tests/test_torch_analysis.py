"""The port's contract linter (``repro_torch.analysis``, DESIGN.md §16, §18)
on the CPU, at the quick grid.

Three parts:

  * the tree is CLEAN: every family runs over the real tree on the CPU and
    reports nothing beyond the port's committed baseline (exactly the
    missing sparse × distributed dispatch cell, as in the reference);
  * every rule FIRES on a seeded violation — an 8-arg ``dissat_fn``, a
    second θ subtraction in Python and in CUDA, an unregistered
    ``is_sparse`` arm, ``.item()`` in a CUDA-graph-captured body, a
    float64 op, an op dispatched from ``repro_torch.obs``, an
    N-dependent candidate, a dense (N, N) intermediate on a sparse budget,
    a wide collective, a missing budget — through ``source_overrides``,
    injected callables and fixture entry points, never the tree on disk;
  * the port is held against the reference: the canonical ``dissat_fn``
    parameters, the symbolic wire sizes, the ledger, the sweep grouping
    grid, the dispatch matrix, the declared budgets, the registered entry
    points and rule names, and the quick-grid exponents (none steeper
    than the reference's ``complexity.json`` beyond ``EXPECTATION_TOL``,
    except the pinned cells below, each a strict xfail with its reason).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import (AnalysisContext, Finding, load_baseline,
                                  registered_rules, run_rules,
                                  split_findings)
from repro_torch.analysis import ast_rules, jaxpr_rules, wire_rules
from repro_torch.analysis import complexity_rules as cx
from repro_torch.analysis import entrypoints

REPO = pathlib.Path(__file__).resolve().parent.parent
QUICK = cx.GRIDS["quick"]
CPU = "cpu"
KNOWN = "dispatch-coverage:sparse-distributed"
_REF_TABLE = json.loads(
    (REPO / "src/repro/analysis/complexity.json").read_text())


def _ctx(**kwargs) -> AnalysisContext:
    return AnalysisContext(repo_root=REPO, device=CPU, **kwargs)


def _quick_profiles():
    return cx.all_profiles("quick", CPU)


def _src(rel: str) -> str:
    return (REPO / rel).read_text()


# ---------------------------------------------------------------------------
# registry, entry points and device
# ---------------------------------------------------------------------------

def test_rules_and_families_equal_the_reference():
    from repro.analysis import registered_rules as ref_rules
    port = {(r.name, r.family) for r in registered_rules()}
    assert port == {(r.name, r.family) for r in ref_rules()}
    assert len(port) == 17


def test_finding_ids_and_baseline_split():
    f1 = Finding(rule="r", key="a", message="m")
    f2 = Finding(rule="r", key="b", message="m")
    new, known, stale = split_findings([f1, f2], {"r:a", "r:gone"})
    assert [f.id for f in new] == ["r:b"]
    assert [f.id for f in known] == ["r:a"]
    assert stale == {"r:gone"}


def test_entry_points_equal_the_reference():
    from repro.analysis import entrypoints as ref
    port = [(e.name, e.runtime, e.rep, e.max_n)
            for e in entrypoints.registered_entry_points()]
    assert port == [(e.name, e.runtime, e.rep, e.max_n)
                    for e in ref.registered_entry_points()]
    assert len(port) == 21


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnalysisContext(repo_root=REPO)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--check", "--families", "ast"])


def test_one_turn_means_one_turn():
    """A record covers set-up plus exactly ``turns`` turns: one reduction
    a turn on the refine loop, two with ``turns=2``."""
    calls = []
    from repro_torch.kernels import ops
    twin = ops.make_aggregate_dissat_fn_plain()

    def counted(*args):
        calls.append(1)
        return twin(*args)

    from repro_torch.core.refine import refine
    prob = entrypoints.canonical_problem(device=CPU)
    for turns in (1, 2):
        calls.clear()
        refine(prob, entrypoints.canonical_assignment(device=CPU),
               max_turns=turns, dissat_fn=counted)
        assert len(calls) == turns


# ---------------------------------------------------------------------------
# record family: zero-callback, dtype drift, sweep stacking
# ---------------------------------------------------------------------------

# the unbounded sweep's first sweep moves no node on the CPU's coins, so
# its run skips add_windows' depth read (one read on the card's draws)
_CPU_HOST_READS = {"refine_sweeps.sparse.unbounded": 0}


@pytest.mark.parametrize("name", [e.name for e in
                                  entrypoints.registered_entry_points()])
def test_entry_point_record_is_clean(name):
    rec = entrypoints.trace_entry_point(name, CPU)
    assert rec.ops
    assert jaxpr_rules.obs_dispatches(rec) == []
    assert jaxpr_rules.host_reads(rec) == _CPU_HOST_READS.get(
        name, jaxpr_rules.HOST_READS[name])
    assert jaxpr_rules.callback_primitives(rec, name) == []
    assert jaxpr_rules.dtype_drift(rec) == []


def test_seeded_obs_dispatch_fires():
    """The recorder-on run of ``refine`` — a fixture entry point whose
    telemetry dispatches from ``repro_torch.obs`` — is flagged."""
    from repro_torch.core.refine import refine
    from repro_torch.obs import Recorder
    prob = entrypoints.canonical_problem(device=CPU)
    r0 = entrypoints.canonical_assignment(device=CPU)
    rec = entrypoints.record(lambda: refine(prob, r0, max_turns=2,
                                            recorder=Recorder()),
                             device=CPU, frames=True)
    hits = jaxpr_rules.obs_dispatches(rec)
    assert hits and "aten.stack.default" in hits
    assert jaxpr_rules.callback_primitives(rec, "refine")


def test_seeded_host_read_fires():
    prob = entrypoints.canonical_problem(device=CPU)

    def leaky():
        return float(torch.sum(prob.node_weights).item())

    rec = entrypoints.record(leaky, device=CPU)
    assert jaxpr_rules.host_reads(rec) == 1
    assert jaxpr_rules.callback_primitives(rec, "refine") == ["host-read"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16, torch.complex64])
def test_seeded_dtype_drift_fires(dtype):
    x = torch.ones(4)
    rec = entrypoints.record(lambda: torch.cumsum(x.to(dtype) * 2, 0),
                             device=CPU)
    drift = dict(jaxpr_rules.dtype_drift(rec))
    assert str(dtype).removeprefix("torch.") in drift


def test_int64_index_ops_are_allowed():
    x = torch.rand(8)
    rec = entrypoints.record(lambda: torch.argmax(x), device=CPU)
    assert rec.ops[0].dtypes == ("int64",)
    assert jaxpr_rules.dtype_drift(rec) == []


def test_sweep_stacking_audit_clean_and_equal_to_the_reference():
    from repro.analysis import jaxpr_rules as ref
    from repro.sweeps.runtime import _group_key as ref_key
    from repro_torch.sweeps.runtime import _group_key
    cases = jaxpr_rules.canonical_sweep_cases(CPU)
    findings, report = jaxpr_rules.group_signature_findings(cases)
    assert findings == []
    assert report == {"cases": 16, "groups": 12, "violations": 0}
    ref_cases = ref.canonical_sweep_cases()
    assert [c.label for c in cases] == [c.label for c in ref_cases]
    assert [_group_key(c) for c in cases] == [ref_key(c) for c in ref_cases]


def test_seeded_dtype_mismatch_breaks_group():
    from repro_torch.sweeps.runtime import SweepCase
    p32 = entrypoints.canonical_problem(device=CPU)
    p64 = dataclasses.replace(p32, adjacency=p32.adjacency.double())
    r0 = entrypoints.canonical_assignment(device=CPU)
    cases = [SweepCase(problem=p, assignment=r0, framework="c",
                       label=str(p.adjacency.dtype)) for p in (p32, p64)]
    findings, _ = jaxpr_rules.group_signature_findings(cases)
    assert findings and "distinct stacking signatures" in findings[0].message


# ---------------------------------------------------------------------------
# AST rules: dissat signature
# ---------------------------------------------------------------------------

def test_dissat_params_equal_the_reference():
    from repro.analysis.ast_rules import \
        CANONICAL_DISSAT_PARAMS as ref_params
    from repro.core.refine import DissatFn as RefDissatFn
    from repro_torch.core.refine import DissatFn
    assert ast_rules.CANONICAL_DISSAT_PARAMS == ref_params

    def params(cls):
        return tuple(inspect.signature(cls.__call__).parameters)[1:]
    assert params(DissatFn) == params(RefDissatFn) == ref_params


def test_repo_dissat_signatures_clean():
    assert ast_rules.dissat_signature_findings(_ctx()) == []


_BAD_FACTORY = textwrap.dedent("""\
    from repro_torch.core.refine import DissatFn


    def make_bad_dissat_fn() -> DissatFn:
        def fn(aggregate, assignment, node_weights, loads, speeds, mu,
               framework, total_weight):
            return None, None
        return fn
    """)


def test_seeded_eight_arg_dissat_fn_fires():
    ctx = _ctx(source_overrides={
        "src/repro_torch/kernels/_seeded.py": _BAD_FACTORY})
    findings = ast_rules.dissat_signature_findings(ctx)
    assert len(findings) == 1
    assert findings[0].key.startswith(
        "def:src/repro_torch/kernels/_seeded.py")
    assert "canonical convention" in findings[0].message


def test_seeded_bad_call_site_fires():
    src = "def caller(dissat_fn, agg):\n    return dissat_fn(agg)\n"
    ctx = _ctx(source_overrides={"src/repro_torch/core/_seeded.py": src})
    findings = ast_rules.dissat_signature_findings(ctx)
    assert len(findings) == 1 and findings[0].key.startswith("call:")


def test_varargs_wrappers_are_exempt():
    src = textwrap.dedent("""\
        from repro_torch.core.refine import DissatFn


        def make_wrapper(inner) -> DissatFn:
            def fn(*args, **kwargs):
                return inner(*args, **kwargs)
            return fn
        """)
    ctx = _ctx(source_overrides={"src/repro_torch/kernels/_seeded.py": src})
    assert ast_rules.dissat_signature_findings(ctx) == []


# ---------------------------------------------------------------------------
# AST rules: single theta-subtraction site (Python and CUDA)
# ---------------------------------------------------------------------------

def test_repo_theta_single_site_clean():
    assert ast_rules.theta_site_findings(_ctx()) == []


def test_cuda_theta_sites_are_the_two_pinned_reductions():
    got = {(p, owner) for p in ("dissatisfaction.cu", "edge_block.cu",
                                "reduce_dissat.cuh")
           for owner, _ in ast_rules.cuda_theta_sites(
               _src(f"src/repro_torch/kernels/csrc/{p}"))}
    assert got == {("dissatisfaction.cu", "dissat_from_aggregate_kernel"),
                   ("edge_block.cu", "block_rows")}


def test_seeded_second_theta_subtraction_fires():
    src = ("def sneaky_netting(dissat, theta):\n"
           "    return dissat - theta\n")
    ctx = _ctx(source_overrides={"src/repro_torch/core/_seeded.py": src})
    findings = ast_rules.theta_site_findings(ctx)
    assert len(findings) == 1
    assert findings[0].key == "src/repro_torch/core/_seeded.py::sneaky_netting"
    assert "ONLY in costs.dissatisfaction_from_cost" in findings[0].message


def test_seeded_second_cuda_theta_subtraction_fires():
    path = "src/repro_torch/kernels/csrc/dissatisfaction.cu"
    text = _src(path)
    anchor = "size_t cost_matrix_smem_bytes(int k) {"
    assert anchor in text
    seeded = text.replace(anchor, textwrap.dedent("""\
        __device__ float net_again(float d, float th) {
          return d - th;  // a second netting, outside the fused reduction
        }

        """) + anchor)
    ctx = _ctx(source_overrides={path: seeded})
    findings = ast_rules.theta_site_findings(ctx)
    assert [f.key for f in findings] == [f"{path}::net_again"]
    assert "CUDA function 'net_again'" in findings[0].message
    # comments and reads of a.theta are not subtractions
    ctx = _ctx(source_overrides={path: text + "\n// x = y - theta;\n"})
    assert ast_rules.theta_site_findings(ctx) == []


def test_removing_canonical_theta_site_fires():
    costs_src = _src("src/repro_torch/core/costs.py")
    patched = costs_src.replace("dissat = dissat - theta", "dissat = dissat")
    assert patched != costs_src
    ctx = _ctx(source_overrides={"src/repro_torch/core/costs.py": patched})
    findings = ast_rules.theta_site_findings(ctx)
    assert any(f.key == "canonical-missing" for f in findings)


# ---------------------------------------------------------------------------
# AST rules: host reads inside CUDA-graph-captured bodies
# ---------------------------------------------------------------------------

def test_repo_trace_unsafe_clean():
    assert ast_rules.trace_unsafe_findings(_ctx()) == []


def test_seeded_item_in_captured_body_fires():
    path = "src/repro_torch/des/engine.py"
    text = _src(path)
    anchor = "            new = _where(live, _tick(cfg, nbr, s, speeds), s)\n"
    assert anchor in text
    seeded = text.replace(anchor, anchor + "            _ = s.tick.item()\n")
    findings = ast_rules.trace_unsafe_findings(
        _ctx(source_overrides={path: seeded}))
    assert len(findings) == 1
    assert findings[0].key.startswith(f"host-read:{path}:")
    assert "_Ticks.__init__.step" in findings[0].message


_CAPTURED = textwrap.dedent("""\
    import numpy as np


    def body(cfg, x, maybe):
        noise = np.random.rand()
        if x > 0:
            return float(x) + noise
        if cfg.flag:
            return x.tolist()
        if maybe is None:
            return x
        return x - 1
    """)


def test_seeded_trace_unsafe_patterns_fire():
    path = "src/repro_torch/des/_seeded.py"
    findings = ast_rules.trace_unsafe_findings(
        _ctx(source_overrides={path: _CAPTURED}),
        captured={(path, "body"): ("cfg",)})
    kinds = sorted(f.key.split(":")[0] for f in findings)
    # np.random, the `if x > 0` tensor branch, float(x), .tolist(); the
    # static `if cfg.flag` and the `is None` test must NOT fire
    assert kinds == ["host-cast", "host-read", "if-tracer", "np-random"]


def test_missing_captured_callable_fires():
    findings = ast_rules.trace_unsafe_findings(
        _ctx(), captured={("src/repro_torch/des/engine.py", "_gone"): ()})
    assert [f.key for f in findings] == [
        "missing:src/repro_torch/des/engine.py::_gone"]


def test_captured_callables_exist():
    names = {q for q, _ in _ctx().functions("src/repro_torch/des/engine.py")}
    assert {q for _, q in ast_rules.CAPTURED} <= names


# ---------------------------------------------------------------------------
# AST rules: dispatch-coverage matrix
# ---------------------------------------------------------------------------

def test_dispatch_matrix_equals_the_reference_cell_by_cell():
    from repro.analysis import ast_rules as ref
    from repro.analysis.registry import AnalysisContext as RefContext
    port = ast_rules.dispatch_matrix(_ctx())
    want = ref.dispatch_matrix(RefContext(repo_root=REPO))
    assert list(port) == list(want) == list(ast_rules.CELL_ORDER)
    assert {c: i["covered"] for c, i in port.items()} == \
        {c: i["covered"] for c, i in want.items()}
    assert [c for c, i in port.items() if not i["covered"]] == \
        ["sparse-distributed"]


def test_repo_dispatch_findings_match_baseline_exactly():
    findings = ast_rules.dispatch_findings(_ctx())
    assert [f.id for f in findings] == [KNOWN]
    assert load_baseline() == {KNOWN}


@pytest.mark.parametrize("arm", ["problem_aggregate", "problem_cut",
                                 "global_cost_c0"])
def test_removing_costs_arm_uncovers_cells(arm):
    costs_src = _src("src/repro_torch/core/costs.py")
    out, in_fn, patched = [], False, False
    for line in costs_src.splitlines(keepends=True):
        if line.startswith(f"def {arm}("):
            in_fn = True
        elif line.startswith("def "):
            in_fn = False
        if in_fn and not patched and "is_sparse(problem)" in line:
            line = line.replace("is_sparse(problem)", "False")
            patched = True
        out.append(line)
    assert patched, f"no is_sparse arm found in {arm}"
    ctx = _ctx(source_overrides={"src/repro_torch/core/costs.py":
                                 "".join(out)})
    ids = {f.id for f in ast_rules.dispatch_findings(ctx)}
    assert "dispatch-coverage:sparse-controller" in ids
    assert "dispatch-coverage:sparse-batched" in ids
    new, _, _ = split_findings(ast_rules.dispatch_findings(ctx),
                               load_baseline())
    assert any(f.key == "sparse-controller" for f in new)


@pytest.mark.parametrize("test", ["costs.is_sparse(problem)",
                                  "isinstance(problem, SparseProblem)"])
def test_unregistered_dispatch_arm_fires(test):
    src = textwrap.dedent(f"""\
        from repro_torch.core import costs
        from repro_torch.core.sparse import SparseProblem


        def rogue_dispatch(problem):
            if {test}:
                return 1
            return 0
        """)
    ctx = _ctx(source_overrides={"src/repro_torch/core/_seeded.py": src})
    assert any(f.key == "arm:src/repro_torch/core/_seeded.py::rogue_dispatch"
               for f in ast_rules.dispatch_findings(ctx))


def test_bare_is_sparse_guard_is_not_an_arm():
    src = ("from repro_torch.core import costs\n\n\n"
           "def guarded(problem):\n"
           "    costs.is_sparse(problem)\n"
           "    return 0\n")
    ctx = _ctx(source_overrides={"src/repro_torch/core/_seeded.py": src})
    assert [f.id for f in ast_rules.dispatch_findings(ctx)] == [KNOWN]


def test_sparse_distributed_arm_would_close_the_gap():
    src = ("from ..core import costs\n\n\n"
           "def dispatch(problem):\n"
           "    return costs.is_sparse(problem)\n")
    ctx = _ctx(source_overrides={
        "src/repro_torch/distributed/_seeded.py": src})
    assert ast_rules.dispatch_matrix(ctx)["sparse-distributed"]["covered"]


# ---------------------------------------------------------------------------
# wire rules
# ---------------------------------------------------------------------------

def test_repo_wire_contracts_clean():
    assert wire_rules.candidate_findings() == []
    assert wire_rules.ledger_findings() == []
    ctx = _ctx()
    assert run_rules(ctx, ["wire"]) == []


def test_symbolic_sizes_equal_the_reference():
    from repro.analysis import wire_rules as ref
    from repro_torch.distributed import protocol
    assert wire_rules.N_GRID == ref.N_GRID
    for n in ref.N_GRID:
        for k in ref._K_GRID:
            assert wire_rules.symbolic_candidate_bytes(n, k) == \
                ref.symbolic_candidate_bytes(n, k) == \
                (protocol.CANDIDATE_BYTES, 0)
            assert wire_rules.symbolic_delta_bytes(n, k) == \
                ref.symbolic_delta_bytes(n, k) == 8
            assert wire_rules.symbolic_load_partial_bytes(n, k) == \
                ref.symbolic_load_partial_bytes(n, k) == 4 * k


def test_ledger_recurring_bytes_equal_the_reference():
    from repro.analysis import wire_rules as ref
    from repro.distributed import accounting as ref_acc
    assert wire_rules._FLAG_COMBOS == ref._FLAG_COMBOS
    for k in ref._K_GRID:
        for traced, simultaneous, incremental in ref._FLAG_COMBOS:
            for n in ref.N_GRID:
                led = ref_acc.ledger_for_run(
                    ref._synthetic_stats(n), k, 10, traced=traced,
                    simultaneous=simultaneous, incremental=incremental)
                assert wire_rules.ledger_recurring_bytes(
                    k, n, traced, simultaneous, incremental) == \
                    led.candidate_bytes + led.trace_bytes + led.setup_bytes


def test_seeded_n_dependent_candidate_fires():
    from repro_torch.distributed import protocol

    def fat_candidate(agg, r_local, b, ids, valid, r, loads, speeds, mu,
                      total_b, machine, framework, with_deltas=False):
        # ships every row's weight: O(Ns) on the wire
        cand = protocol.Candidate(gain=b, node=ids, dest=ids, weight=b)
        if with_deltas:
            return cand, b[:, 0], b[:, 0]
        return cand

    findings = wire_rules.candidate_findings(candidate_fn=fat_candidate)
    assert any(f.key.startswith("candidate-n-dep") for f in findings)
    assert any("O(K) wire contract" in f.message for f in findings)


def test_seeded_n_dependent_ledger_fires():
    from repro_torch.distributed import accounting

    def bad_ledger(stats, k, rounds, **flags):
        led = accounting.ledger_for_run(stats, k, rounds, **flags)
        return dataclasses.replace(
            led, candidate_bytes=led.candidate_bytes
            + rounds * 4 * stats.num_nodes)

    findings = wire_rules.ledger_findings(ledger_fn=bad_ledger)
    assert findings
    assert all("depend on N" in f.message for f in findings)


# ---------------------------------------------------------------------------
# complexity: declared budgets
# ---------------------------------------------------------------------------

def test_declared_budgets_equal_the_reference():
    """The six declarations, pinned: values equal to the reference's,
    keys the registered entry points."""
    import repro.core.costs as ref_costs
    import repro.core.sparse as ref_sparse
    import repro.des.engine as ref_des
    import repro.distributed.runtime as ref_rt
    import repro.kernels.ops as ref_ops
    from repro_torch.core import costs, sparse
    from repro_torch.des import engine
    from repro_torch.distributed import runtime
    from repro_torch.kernels import ops
    pairs = [(costs.DENSE_COMPLEXITY, ref_costs.DENSE_COMPLEXITY),
             (sparse.SPARSE_COMPLEXITY, ref_sparse.SPARSE_COMPLEXITY),
             (ops.KERNEL_COMPLEXITY, ref_ops.KERNEL_COMPLEXITY),
             (engine.DES_COMPLEXITY, ref_des.DES_COMPLEXITY),
             (runtime.DISTRIBUTED_COMPLEXITY, ref_rt.DISTRIBUTED_COMPLEXITY),
             (runtime.DISTRIBUTED_COLLECTIVES,
              ref_rt.DISTRIBUTED_COLLECTIVES)]
    for port, ref in pairs:
        assert port == ref
    names = {e.name for e in entrypoints.registered_entry_points()}
    assert set(ops.KERNEL_COMPLEXITY) == {"refine.kernel",
                                          "refine.sparse.edge_kernel"}
    assert set(ops.KERNEL_COMPLEXITY) <= names
    assert set(runtime.DISTRIBUTED_COLLECTIVES) == {
        e.name for e in entrypoints.registered_entry_points()
        if e.runtime == "distributed"}
    assert runtime.DISTRIBUTED_COLLECTIVES["distributed.shard_map"] == {
        "recurring_bytes": 16, "setup_bytes": 0}


def test_every_entry_point_has_declared_budget():
    for ep in entrypoints.registered_entry_points():
        budget = cx.declared_budget(ep)
        assert budget is not None, ep.name
        assert set(budget) == {"mem", "ops", "collectives"}


def test_missing_budget_fires():
    eps = entrypoints.registered_entry_points()
    findings = cx.budget_findings(eps, lookup=lambda ep: None)
    assert len(findings) == len(eps)
    assert all(f.rule == "complexity-budget-declared" for f in findings)
    assert cx.budget_findings(eps) == []


# ---------------------------------------------------------------------------
# complexity: real profiles at the quick grid
# ---------------------------------------------------------------------------

def test_grids_and_tolerances_equal_the_reference():
    from repro.analysis import complexity_rules as ref
    assert {g: dataclasses.asdict(v) for g, v in cx.GRIDS.items()} == \
        {g: dataclasses.asdict(v) for g, v in ref.GRIDS.items()}
    assert (cx.EXPONENT_TOL, cx.EXPECTATION_TOL) == \
        (ref.EXPONENT_TOL, ref.EXPECTATION_TOL)


def test_fit_exponent_recovers_power_laws():
    ns = (32, 64, 128, 256)
    assert abs(cx.fit_exponent(ns, [n * n for n in ns]) - 2.0) < 1e-9
    assert abs(cx.fit_exponent(ns, [7 * n for n in ns]) - 1.0) < 1e-9
    assert abs(cx.fit_exponent(ns, [5, 5, 5, 5])) < 1e-9
    assert cx.fit_exponent((4,), (16,)) == 0.0


def test_sparse_paths_have_linear_memory():
    profs = _quick_profiles()
    for name in ("refine.sparse", "refine_traced.sparse",
                 "refine.sparse.edge_kernel",
                 "refine_sweeps.sparse.unbounded"):
        fits = profs[name]["fits"]
        assert fits["mem"]["n"] <= 1.0 + cx.EXPONENT_TOL, (name, fits)
        assert fits["mem"]["e"] <= 1.0 + cx.EXPONENT_TOL, (name, fits)


def test_dense_paths_sit_at_the_quadratic_floor():
    prof = _quick_profiles()["refine"]
    assert abs(prof["fits"]["mem"]["n"] - 2.0) < 0.1
    assert prof["peak_shape"] == (256, 256)


def test_shard_map_collectives_match_ledger():
    coll = _quick_profiles()["distributed.shard_map"]["collectives"]
    assert coll["n_independent"]
    assert coll["recurring_bytes"] == 16
    assert coll["setup_bytes"] == 0
    # one candidate a round: one all-gather of a (4,) int32 message
    assert coll["schedule"] == (("all-gather", "recurring", 16),)


def test_emulated_drivers_issue_zero_collectives():
    profs = _quick_profiles()
    for name in ("distributed.refine", "distributed.refine_traced",
                 "distributed.refine_simultaneous"):
        assert profs[name]["collectives"]["schedule"] == ()


def test_no_findings_on_the_real_tree():
    ctx = _ctx(complexity_grid="quick")
    findings = run_rules(ctx, families=["complexity"])
    assert findings == [], [f.id for f in findings]
    report = ctx.reports["complexity"]
    assert report["grid"] == "quick" and report["section"] == "quick/cpu"
    assert len(report["entry_points"]) == 21


def test_checked_in_table_agrees_with_quick_refit():
    findings = cx.expectation_findings(_quick_profiles(), cx.load_table(),
                                       "quick/cpu")
    assert findings == [], [f.id for f in findings]


# The quick-grid cells where the port's fitted exponent is steeper than
# the reference's by more than EXPECTATION_TOL (ROADMAP queue 3).  None is
# a steeper asymptote of the port; each is a difference of what the two
# measures see:
_K_SUMS = ("the port's costs.row_sum adds the K columns one at a time "
           "(the kernels' rounding order), and each partial sum counts its "
           "N outputs; the reference's one reduce_sum counts N")
_NO_NN = ("the port's collective driver builds no (N, N) intermediate: its "
          "peak is the (N, K) aggregate (N exponent 1.0, the reference's 2.0)")
_PALLAS_PAD = ("the reference's record is Pallas in interpret mode, whose "
               "padded tiles flatten its quick-grid fit; the port's CPU "
               "record is the plain twin")
_EDGE_LONG = ("the port's peak is an O(E) int64 index copy (exponent ~1 in "
              "E); the reference's is a padded (N, max_degree, K) window")
STEEPER_THAN_REFERENCE = {
    ("batch.refine_simultaneous", "ops", "k"): _K_SUMS,
    ("batch.refine_sweeps", "ops", "k"): _K_SUMS,
    ("refine_simultaneous", "ops", "k"): _K_SUMS,
    ("refine_sweeps", "ops", "k"): _K_SUMS,
    ("distributed.refine", "ops", "k"): _K_SUMS,
    ("distributed.refine_simultaneous", "ops", "k"): _K_SUMS,
    ("refine.sparse", "ops", "k"): _K_SUMS,
    ("refine_traced.sparse", "ops", "k"): _K_SUMS,
    ("refine_sweeps.sparse.unbounded", "ops", "k"): _K_SUMS,
    ("distributed.shard_map", "mem", "k"): _NO_NN,
    ("distributed.shard_map", "ops", "k"): _NO_NN,
    ("refine.kernel", "mem", "n"): _PALLAS_PAD,
    ("refine.kernel", "ops", "n"): _PALLAS_PAD,
    ("refine.kernel", "ops", "k"): _PALLAS_PAD,
    ("refine.sparse.edge_kernel", "mem", "n"): _PALLAS_PAD,
    ("refine.sparse.edge_kernel", "mem", "e"): _PALLAS_PAD,
    ("refine.sparse.edge_kernel", "ops", "n"): _PALLAS_PAD,
    ("refine.sparse.edge_kernel", "ops", "e"): _PALLAS_PAD,
    ("refine.sparse.edge_kernel", "ops", "k"): _PALLAS_PAD,
    ("refine_sweeps.sparse.unbounded", "mem", "e"): _EDGE_LONG,
}


def _reference_cells():
    out = []
    for name, entry in sorted(_REF_TABLE["grids"]["quick"].items()):
        for metric, dims in sorted(entry["fits"].items()):
            for dim in sorted(dims):
                cell = (name, metric, dim)
                marks = ()
                if cell in STEEPER_THAN_REFERENCE:
                    marks = pytest.mark.xfail(
                        strict=True, reason=STEEPER_THAN_REFERENCE[cell])
                out.append(pytest.param(*cell, marks=marks,
                                        id=f"{name}-{metric}.{dim}"))
    return out


@pytest.mark.parametrize("name,metric,dim", _reference_cells())
def test_quick_exponent_not_steeper_than_the_reference(name, metric, dim):
    got = _quick_profiles()[name]["fits"][metric][dim]
    want = _REF_TABLE["grids"]["quick"][name]["fits"][metric][dim]
    assert got <= want + cx.EXPECTATION_TOL, (got, want)


# ---------------------------------------------------------------------------
# complexity: seeded violations
# ---------------------------------------------------------------------------

def _dense_mask_trace(n, k, degree, turns=1):
    """A 'sparse' fixture that secretly materializes a dense (E, E) mask
    — the exact regression the mem rule exists to catch."""
    sp = entrypoints.canonical_sparse_degree(n, k, degree or 8, device=CPU)

    def run():
        mask = sp.senders[:, None] == sp.receivers[None, :]
        return torch.sum(torch.where(mask, 1.0, 0.0))
    return entrypoints.record(run, device=CPU)


def test_seeded_dense_materialization_fails_mem_budget():
    from repro_torch.core.sparse import SPARSE_COMPLEXITY
    prof = cx.profile_trace(_dense_mask_trace, QUICK, sparse=True)
    assert prof["fits"]["mem"]["n"] > 1.8
    budget = SPARSE_COMPLEXITY | {"collectives": {}}
    findings = cx.exponent_findings("seeded.densemask", prof, budget, "mem")
    keys = {f.key for f in findings}
    assert {"seeded.densemask:n", "seeded.densemask:e"} <= keys
    assert all(f.rule == "complexity-mem-budget" for f in findings)
    assert "peak intermediate" in next(
        f.message for f in findings if f.key == "seeded.densemask:n")
    ops = cx.exponent_findings("seeded.densemask", prof, budget, "ops")
    assert any(f.key == "seeded.densemask:n" for f in ops)
    assert all(f.rule == "complexity-ops-budget" for f in ops)


def test_mem_device_fits_are_held_to_the_mem_budget():
    prof = {"fits": {"mem_device": {"n": 2.1, "k": 0.0}}}
    budget = {"mem": {"n": 1.0, "k": 1.0}, "ops": {}}
    findings = cx.exponent_findings("seeded.alloc", prof, budget,
                                    "mem_device")
    assert [(f.rule, f.key) for f in findings] == [
        ("complexity-mem-budget", "seeded.alloc:n:device")]


def _wide_all_reduce_trace(n, k, degree, turns=1):
    """An all-reduce of an (N,) operand every turn — the collective audit
    must reject it twice over."""
    import torch.distributed as dist
    x = torch.ones(n)

    def run():
        for _ in range(turns):
            dist.all_reduce(x.clone())
    with entrypoints.one_rank_group(CPU):
        return entrypoints.record(run, device=CPU)


def test_seeded_wide_collective_fails_collective_audit():
    prof = cx.profile_trace(_wide_all_reduce_trace, QUICK, collectives=True)
    coll = prof["collectives"]
    assert not coll["n_independent"]
    assert coll["recurring_bytes"] == 4 * QUICK.n[-1]
    findings = cx.collective_findings(
        "seeded.allreduce", coll, {"recurring_bytes": 0, "setup_bytes": 0})
    assert {f.key for f in findings} == {"seeded.allreduce:n-dependent",
                                         "seeded.allreduce:recurring-bytes"}


# ---------------------------------------------------------------------------
# expectation table lifecycle
# ---------------------------------------------------------------------------

def test_expectation_table_missing_section_and_drift_and_stale():
    profiles = {"refine": cx.profile_entry_point("refine", "quick", CPU)}
    missing = cx.expectation_findings(profiles, {}, "quick/cpu")
    assert [f.key for f in missing] == ["table:quick/cpu"]
    table = {"grids": {"quick/cpu": {
        "refine": cx.build_table_entry(profiles["refine"]),
        "ghost.entry": cx.build_table_entry(profiles["refine"]),
    }}}
    findings = cx.expectation_findings(profiles, table, "quick/cpu")
    assert [f.key for f in findings] == ["stale:ghost.entry"]
    drifted = json.loads(json.dumps(table))
    drifted["grids"]["quick/cpu"]["refine"]["fits"]["mem"]["n"] += 0.5
    del drifted["grids"]["quick/cpu"]["ghost.entry"]
    findings = cx.expectation_findings(profiles, drifted, "quick/cpu")
    assert [f.key for f in findings] == ["refine:mem.n"]


def test_table_sections_are_grid_and_device():
    sections = set(cx.load_table()["grids"])
    assert "quick/cpu" in sections
    assert sections <= {"quick/cpu", "full/cuda"}
    assert cx.section_name("full", torch.device("cuda", 0)) == "full/cuda"


def test_update_table_roundtrip(tmp_path):
    path = tmp_path / "complexity.json"
    cx.update_table("quick", path, CPU)
    table = cx.load_table(path)
    assert set(table["grids"]) == {"quick/cpu"}
    assert len(table["grids"]["quick/cpu"]) == 21
    before = path.read_text()
    cx.update_table("quick", path, CPU)
    assert path.read_text() == before


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _main(argv):
    from repro_torch.analysis.__main__ import main
    return main(argv)


def test_cli_check_passes_on_the_cpu_and_writes_json(tmp_path, capsys):
    out = tmp_path / "findings.json"
    assert _main(["--check", "--device", CPU, "--complexity-grid", "quick",
                  "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["new"] == [] and report["baselined"] == [KNOWN]
    assert report["device"] == CPU
    assert len(report["reports"]["jaxpr-zero-callback"]["entry_points"]) \
        == 21
    shard = report["reports"]["complexity"]["entry_points"][
        "distributed.shard_map"]
    assert shard["collectives"]["recurring_bytes"] == 16
    text = capsys.readouterr().out
    assert "sparse-distributed" in text and "MISSING" in text


def _baseline_file(tmp_path, entries):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"findings": entries}, indent=2) + "\n")
    return p


_KNOWN_ENTRY = {"rule": "dispatch-coverage", "key": "sparse-distributed"}


def test_cli_exit_codes_known_new_stale(tmp_path, capsys):
    common = ["--check", "--families", "ast", "--device", CPU]
    b = _baseline_file(tmp_path, [_KNOWN_ENTRY])
    assert _main(common + ["--baseline", str(b)]) == 0
    b = _baseline_file(tmp_path, [])
    assert _main(common + ["--baseline", str(b)]) == 2
    assert "FAIL" in capsys.readouterr().out
    b = _baseline_file(tmp_path, [_KNOWN_ENTRY, {"rule": "ghost", "key": "x"}])
    before = b.read_text()
    assert _main(common + ["--baseline", str(b)]) == 0
    assert b.read_text() == before


def test_cli_prune_and_update_baseline(tmp_path):
    common = ["--families", "ast", "--device", CPU]
    b = _baseline_file(tmp_path, [_KNOWN_ENTRY, {"rule": "ghost", "key": "x"}])
    assert _main(["--check", "--prune-stale", *common,
                  "--baseline", str(b)]) == 0
    assert json.loads(b.read_text())["findings"] == [_KNOWN_ENTRY]
    b = _baseline_file(tmp_path, [{"rule": "ghost", "key": "x"},
                                  _KNOWN_ENTRY, _KNOWN_ENTRY])
    assert _main(["--update-baseline", *common, "--baseline", str(b)]) == 0
    assert json.loads(b.read_text())["findings"] == [_KNOWN_ENTRY]


def test_cli_update_complexity_writes_its_section(tmp_path, capsys):
    path = tmp_path / "table.json"
    assert _main(["--update-complexity", "--complexity-grid", "quick",
                  "--device", CPU, "--complexity-table", str(path)]) == 0
    assert "'quick/cpu'" in capsys.readouterr().out
    assert set(json.loads(path.read_text())["grids"]) == {"quick/cpu"}


def test_cli_json_is_deterministic_and_stamped(tmp_path):
    out1, out2 = tmp_path / "a.json", tmp_path / "b.json"
    for out in (out1, out2):
        assert _main(["--families", "ast", "--device", CPU,
                      "--json", str(out)]) == 0
    r1, r2 = json.loads(out1.read_text()), json.loads(out2.read_text())
    for r in (r1, r2):
        assert {"git_sha", "torch", "device"} <= set(r["provenance"])
        ids = [f["id"] for f in r["findings"]]
        assert ids == sorted(ids)
    for k in ("rules", "findings", "new", "baselined", "stale_baseline",
              "reports"):
        assert r1[k] == r2[k]
