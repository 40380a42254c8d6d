"""AST-family lint rules (stdlib ``ast``, DESIGN.md §16.4), PyTorch port of
``repro.analysis.ast_rules``.

Four rules over the port's source tree — no imports of the linted
modules, so they run in milliseconds and catch violations before
anything runs:

  * **dissat-signature** — every ``dissat_fn`` produced by a factory
    annotated ``-> DissatFn`` (the Protocol of ``core/refine.py``) has
    exactly the canonical 9 parameters, in order, with the canonical
    names; every ``dissat_fn(...)`` call site passes exactly 9
    positionals.
  * **theta-single-site** — the Eq.-4 net-of-price subtraction
    ``dissat - theta`` happens in exactly ONE torch function
    (``costs.dissatisfaction_from_cost``); the plain twin of the fused
    reduction (``kernels/dissatisfaction.py::reduce_dissat_tile_plain``)
    and the two CUDA reductions that mirror it are a fixed, documented
    allowlist, each held against the torch path by the kernel tests.
    The CUDA sources (``kernels/csrc/*.cu``, ``*.cuh``) are scanned as
    text: a subtraction whose right operand is ``th`` or ``theta...``
    outside the allowlisted kernel functions is a finding too.
  * **trace-unsafe** — the port has no jitted bodies; its counterpart is
    the body of a CUDA-graph capture, which records the launches once
    and replays them without the host.  Inside the registered captured
    callables (:data:`CAPTURED`): no ``.item()`` / ``.tolist()`` /
    ``.cpu()`` / ``.numpy()``, no ``float()``/``int()``/``bool()`` of a
    tensor argument, no ``if`` on a tensor argument, no ``np.random``.
    ``is None`` tests and tests over the registered static parameters
    are capture-time constants and exempt.  A registered callable that
    no longer exists is a finding.
  * **dispatch-coverage** — rebuild the dense/sparse × runtime × kernel
    dispatch matrix from the port's sparse arms: ``isinstance(...,
    SparseProblem)`` and the ``costs.is_sparse(problem)`` calls it
    dispatches through (a bare ``is_sparse(problem)`` statement is a
    type guard, not an arm); missing cells are findings (today exactly
    ``sparse-distributed``, absorbed by the baseline), and removing any
    registered arm uncovers a cell.
"""
from __future__ import annotations

import ast
import re

from .registry import AnalysisContext, Finding, rule, walk_functions

__all__ = ["CANONICAL_DISSAT_PARAMS", "CAPTURED", "dissat_signature_findings",
           "theta_site_findings", "cuda_theta_sites", "trace_unsafe_findings",
           "dispatch_matrix", "dispatch_findings", "CELL_ORDER"]

CANONICAL_DISSAT_PARAMS = (
    "aggregate", "assignment", "node_weights", "loads", "speeds", "mu",
    "framework", "total_weight", "theta")

_SRC_DIR = "src/repro_torch"
_CSRC_DIR = "src/repro_torch/kernels/csrc"


def _mentioning(ctx: AnalysisContext, *words: str) -> list[str]:
    """The port's .py files whose text holds one of ``words`` — the only
    files a rule keyed on those names can fire in (the others are never
    parsed)."""
    return [p for p in ctx.py_files(_SRC_DIR)
            if any(w in ctx.source(p) for w in words)]


def _param_names(fn: ast.FunctionDef) -> tuple[str, ...]:
    a = fn.args
    return tuple(p.arg for p in (*a.posonlyargs, *a.args))


# -- rule: dissat-signature ------------------------------------------------

def _mentions(node: ast.AST | None, name: str) -> bool:
    return node is not None and name in ast.unparse(node)


def dissat_signature_findings(ctx: AnalysisContext) -> list[Finding]:
    findings: list[Finding] = []
    factories = 0
    for path in _mentioning(ctx, "DissatFn", "dissat_fn"):
        tree = ctx.tree(path)
        for qual, fn in ctx.functions(path):
            # Protocol itself: DissatFn.__call__ pins the canonical names
            if qual.endswith("DissatFn.__call__"):
                params = _param_names(fn)[1:]        # drop self
                if params != CANONICAL_DISSAT_PARAMS:
                    findings.append(Finding(
                        rule="dissat-signature", key=f"protocol:{path}",
                        file=path, line=fn.lineno,
                        message=f"DissatFn.__call__ params {params} != "
                                f"canonical {CANONICAL_DISSAT_PARAMS}"))
                continue
            if not _mentions(fn.returns, "DissatFn"):
                continue
            factories += 1
            for inner_qual, inner in walk_functions(
                    ast.Module(body=fn.body, type_ignores=[])):
                if inner.args.vararg is not None:
                    continue   # pass-through wrapper (*args, **kwargs)
                params = _param_names(inner)
                if params != CANONICAL_DISSAT_PARAMS:
                    findings.append(Finding(
                        rule="dissat-signature",
                        key=f"def:{path}::{qual}.{inner_qual}",
                        file=path, line=inner.lineno,
                        message=f"dissat_fn factory {qual!r} returns a "
                                f"function with params {params}; the "
                                f"canonical convention is "
                                f"{CANONICAL_DISSAT_PARAMS} "
                                f"(repro_torch.core.refine)"))
        # call sites: dissat_fn(...) must pass exactly 9 positionals
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.id if isinstance(func, ast.Name) else (
                func.attr if isinstance(func, ast.Attribute) else None)
            if name != "dissat_fn":
                continue
            if any(isinstance(a, ast.Starred) for a in node.args):
                continue   # pass-through wrapper
            if len(node.args) != len(CANONICAL_DISSAT_PARAMS) or \
                    node.keywords:
                findings.append(Finding(
                    rule="dissat-signature",
                    key=f"call:{path}:{node.lineno}",
                    file=path, line=node.lineno,
                    message=f"dissat_fn call passes {len(node.args)} "
                            f"positional + {len(node.keywords)} keyword "
                            f"args; the convention is exactly "
                            f"{len(CANONICAL_DISSAT_PARAMS)} positionals"))
    if factories == 0:
        findings.append(Finding(
            rule="dissat-signature", key="no-factories",
            message="no `-> DissatFn`-annotated factory found under "
                    "src/repro_torch — the lint anchor "
                    "(core.refine.DissatFn) is gone"))
    return findings


@rule("dissat-signature", "ast")
def _rule_dissat_signature(ctx: AnalysisContext) -> list[Finding]:
    """Canonical 9-arg dissat_fn signature at every def/call site."""
    return dissat_signature_findings(ctx)


# -- rule: theta-single-site -----------------------------------------------

_THETA_CANONICAL = ("src/repro_torch/core/costs.py",
                    "dissatisfaction_from_cost")
# the plain twin of the fused reduction (kernels 1 and 3, and through it
# kernels 4 and 5's twins), held against the torch path by the kernel
# tests
_THETA_MIRRORS = frozenset({
    ("src/repro_torch/kernels/dissatisfaction.py",
     "reduce_dissat_tile_plain"),
})
# the CUDA reductions that subtract theta inside the fused kernels: one in
# kernels 1 and 3's row reduction, one in kernels 4 and 5's; each held
# against its twin by chip_smoke.py and tests/test_torch_gpu.py
_THETA_CUDA_MIRRORS = frozenset({
    ("src/repro_torch/kernels/csrc/dissatisfaction.cu",
     "dissat_from_aggregate_kernel"),
    ("src/repro_torch/kernels/csrc/edge_block.cu", "block_rows"),
})


def _is_theta_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id.startswith("theta")
    if isinstance(node, ast.Subscript):
        return _is_theta_expr(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr.startswith("theta")
    return False


_C_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)
_C_THETA_SUB = re.compile(
    r"(?:[\w\)\]]\s*-|-=)\s*(?:[A-Za-z_]\w*(?:\.|->))*(?:th|theta\w*)\b"
    r"(?!\s*(?:\.|->|\())")
_C_FUNCTION = re.compile(
    r"\b([A-Za-z_]\w*)\s*\((?:[^;{}()]|\([^()]*\))*\)\s*(?:const\s*)?\{")
_C_NOT_FUNCTIONS = frozenset({"if", "for", "while", "switch", "catch",
                              "constexpr",
                              "return", "sizeof", "defined"})


def _strip_c_comments(text: str) -> str:
    """``text`` with comments blanked, newlines kept (line numbers hold)."""
    return _C_COMMENT.sub(lambda m: re.sub(r"[^\n]", " ", m.group()), text)


def cuda_theta_sites(source: str) -> list[tuple[str, int]]:
    """``(enclosing function, line)`` of every theta subtraction in one
    CUDA source (comments ignored)."""
    text = _strip_c_comments(source)
    defs = [(m.start(), m.group(1)) for m in _C_FUNCTION.finditer(text)
            if m.group(1) not in _C_NOT_FUNCTIONS]
    out = []
    for m in _C_THETA_SUB.finditer(text):
        owner = ""
        for start, name in defs:
            if start > m.start():
                break
            owner = name
        out.append((owner, text.count("\n", 0, m.start()) + 1))
    return out


def theta_site_findings(ctx: AnalysisContext) -> list[Finding]:
    findings: list[Finding] = []
    sites: set[tuple[str, str]] = set()
    lines: dict[tuple[str, str], int] = {}
    for path in _mentioning(ctx, "theta"):
        for qual, fn in ctx.functions(path):
            for node in ast.walk(fn):
                if isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.Sub) and \
                        _is_theta_expr(node.right):
                    sites.add((path, qual))
                    lines.setdefault((path, qual), node.lineno)
    cuda_sites: set[tuple[str, str]] = set()
    for path in ctx.files(_CSRC_DIR, suffixes=(".cu", ".cuh")):
        for owner, line in cuda_theta_sites(ctx.source(path)):
            cuda_sites.add((path, owner))
            lines.setdefault((path, owner), line)
    for site in sorted(sites):
        if site == _THETA_CANONICAL or site in _THETA_MIRRORS:
            continue
        findings.append(Finding(
            rule="theta-single-site", key=f"{site[0]}::{site[1]}",
            file=site[0], line=lines[site],
            message=f"theta is subtracted in {site[1]!r} ({site[0]}); "
                    f"the Eq.-4 net-of-price subtraction must happen "
                    f"ONLY in costs.dissatisfaction_from_cost (plus the "
                    f"pinned kernel mirrors) — DESIGN.md §11"))
    for site in sorted(cuda_sites - _THETA_CUDA_MIRRORS):
        findings.append(Finding(
            rule="theta-single-site", key=f"{site[0]}::{site[1]}",
            file=site[0], line=lines[site],
            message=f"theta is subtracted in CUDA function {site[1]!r} "
                    f"({site[0]}:{lines[site]}); a CUDA kernel nets theta "
                    f"only in its one pinned fused reduction — DESIGN.md "
                    f"§11"))
    if _THETA_CANONICAL not in sites:
        findings.append(Finding(
            rule="theta-single-site", key="canonical-missing",
            file=_THETA_CANONICAL[0],
            message="the canonical theta-subtraction site "
                    "costs.dissatisfaction_from_cost no longer subtracts "
                    "theta — the hysteresis contract moved or vanished"))
    return findings


@rule("theta-single-site", "ast")
def _rule_theta_site(ctx: AnalysisContext) -> list[Finding]:
    """Eq.-4 theta subtraction occurs in exactly one torch function."""
    return theta_site_findings(ctx)


# -- rule: trace-unsafe ----------------------------------------------------

# The callables a CUDA graph captures (``des/engine.py``: ``_Ticks``
# captures ``step``, which runs a tick's phases P0-P5), each with the
# parameters that are capture-time constants (configs, shapes, flags).
CAPTURED = {
    ("src/repro_torch/des/engine.py", "_Ticks.__init__.step"): (),
    ("src/repro_torch/des/engine.py", "_tick"): ("cfg",),
    ("src/repro_torch/des/engine.py", "_alive"): ("cfg",),
    ("src/repro_torch/des/engine.py", "_where"): (),
    ("src/repro_torch/des/engine.py", "_tick_row"): ("cfg",),
    ("src/repro_torch/des/engine.py", "_segments"): (),
    ("src/repro_torch/des/engine.py", "_select_events"): (),
    ("src/repro_torch/des/engine.py", "_rollback_slots"): (),
    ("src/repro_torch/des/engine.py", "_coalesce"): (),
    ("src/repro_torch/des/engine.py", "_machine_counts"): ("k",),
    ("src/repro_torch/des/engine.py", "_thread_min"): ("num_threads",),
    ("src/repro_torch/des/engine.py", "_thread_any"): ("num_threads",),
    ("src/repro_torch/des/engine.py", "_first"): (),
    ("src/repro_torch/des/engine.py", "_first_max"): (),
    ("src/repro_torch/des/engine.py", "_first_min"): (),
    ("src/repro_torch/des/engine.py", "_take"): (),
    ("src/repro_torch/des/engine.py", "_put"): (),
}

_HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})


def _is_none_test(test: ast.AST) -> bool:
    """True for tests that are pure `x is (not) None` (possibly and/or
    combined, possibly negated) — capture-time constants for optional
    operands."""
    if isinstance(test, ast.BoolOp):
        return all(_is_none_test(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_none_test(test.operand)
    return (isinstance(test, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot))
                    for op in test.ops))


def _dynamic_params(fn: ast.FunctionDef, statics) -> set[str]:
    """The parameters of ``fn`` and of every function nested in it,
    less the registered statics: the tensors a capture sees."""
    names: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            a = node.args
            names.update(p.arg for p in (*a.posonlyargs, *a.args,
                                         *a.kwonlyargs))
    return names - set(statics)


def _unsafe_nodes(path: str, qual: str, fn: ast.FunctionDef, statics):
    dynamic = _dynamic_params(fn, statics)
    where = f"CUDA-graph-captured {qual!r}"
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr == "random" and \
                isinstance(node.value, ast.Name) and \
                node.value.id in ("np", "numpy"):
            yield Finding(
                rule="trace-unsafe", key=f"np-random:{path}:{node.lineno}",
                file=path, line=node.lineno,
                message=f"np.random inside {where}: host randomness is "
                        f"drawn once at capture time and replayed")
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_READS and not node.args:
            yield Finding(
                rule="trace-unsafe", key=f"host-read:{path}:{node.lineno}",
                file=path, line=node.lineno,
                message=f".{node.func.attr}() inside {where}: a host read "
                        f"syncs the stream, and a capture cannot replay "
                        f"it")
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in ("float", "int", "bool") and \
                any(isinstance(a, ast.Name) and a.id in dynamic
                    for a in node.args):
            yield Finding(
                rule="trace-unsafe", key=f"host-cast:{path}:{node.lineno}",
                file=path, line=node.lineno,
                message=f"{node.func.id}() on a tensor argument inside "
                        f"{where}: the value is read once at capture "
                        f"time and frozen into every replay")
        elif isinstance(node, ast.If) and not _is_none_test(node.test):
            names = {n.id for n in ast.walk(node.test)
                     if isinstance(n, ast.Name)}
            hit = sorted(names & dynamic)
            if hit:
                yield Finding(
                    rule="trace-unsafe", key=f"if-tracer:{path}:{node.lineno}",
                    file=path, line=node.lineno,
                    message=f"`if` on tensor argument(s) {hit} inside "
                            f"{where}: the branch is taken at capture "
                            f"time, not per replay — use torch.where or "
                            f"register the argument as static")


def trace_unsafe_findings(ctx: AnalysisContext,
                          captured: dict | None = None) -> list[Finding]:
    captured = CAPTURED if captured is None else captured
    findings: list[Finding] = []
    by_path: dict[str, dict[str, tuple]] = {}
    for (path, qual), statics in captured.items():
        by_path.setdefault(path, {})[qual] = statics
    for path, quals in sorted(by_path.items()):
        try:
            defs = dict(ctx.functions(path))
        except FileNotFoundError:
            defs = {}
        for qual, statics in sorted(quals.items()):
            fn = defs.get(qual)
            if fn is None:
                findings.append(Finding(
                    rule="trace-unsafe", key=f"missing:{path}::{qual}",
                    file=path,
                    message=f"registered captured callable {qual!r} no "
                            f"longer exists in {path} — update "
                            f"repro_torch.analysis.ast_rules.CAPTURED"))
                continue
            findings.extend(_unsafe_nodes(path, qual, fn, statics))
    return findings


@rule("trace-unsafe", "ast")
def _rule_trace_unsafe(ctx: AnalysisContext) -> list[Finding]:
    """No host reads / casts / tensor `if`s inside CUDA-graph captures."""
    return trace_unsafe_findings(ctx)


# -- rule: dispatch-coverage -----------------------------------------------

# every sparse dispatch arm must be registered here; the cells below
# declare which arms make each matrix cell covered
_REGISTERED_ARMS = frozenset({
    ("src/repro_torch/core/costs.py", "is_sparse"),
    ("src/repro_torch/core/costs.py", "problem_aggregate"),
    ("src/repro_torch/core/costs.py", "problem_cut"),
    ("src/repro_torch/core/costs.py", "global_cost_c0"),
    ("src/repro_torch/core/aggregate.py", "apply_move"),
    ("src/repro_torch/core/aggregate.py", "apply_sweep"),
    ("src/repro_torch/core/aggregate.py", "moves_aggregate"),
    ("src/repro_torch/core/aggregate.py", "apply_cluster_move"),
    ("src/repro_torch/core/cluster.py", "h_hop_mask"),
    ("src/repro_torch/core/batch.py", "problem_shape_key"),
    ("src/repro_torch/core/batch.py", "_refine_sweeps_fleet"),
    ("src/repro_torch/core/batch.py", "_apply_unbounded"),
})

# the fleet's own arms (its stacking key, its sweep loop's window and
# mover-buffer updates), as the reference sets its batch.py arms apart
_BATCH_ARMS = frozenset(a for a in _REGISTERED_ARMS
                        if a[0] == "src/repro_torch/core/batch.py")
_CORE_SPARSE_ARMS = _REGISTERED_ARMS - _BATCH_ARMS

# (file, function) definitions whose presence covers the dense cells
_DENSE_DEFS = {
    "dense-controller": (
        ("src/repro_torch/core/refine.py", "refine"),
        ("src/repro_torch/core/refine.py", "refine_traced"),
        ("src/repro_torch/core/refine.py", "refine_simultaneous")),
    "dense-batched": (
        ("src/repro_torch/core/batch.py", "refine_batched"),
        ("src/repro_torch/core/batch.py", "refine_traced_batched"),
        ("src/repro_torch/core/batch.py", "refine_simultaneous_batched")),
    "dense-distributed": (
        ("src/repro_torch/distributed/runtime.py", "_refine_distributed"),
        ("src/repro_torch/distributed/runtime.py",
         "_refine_distributed_traced"),
        ("src/repro_torch/distributed/runtime.py",
         "_refine_distributed_simultaneous"),
        ("src/repro_torch/distributed/runtime.py",
         "refine_distributed_shard_map")),
    "dense-kernel": (("src/repro_torch/kernels/ops.py",
                      "make_aggregate_dissat_fn"),),
    "sparse-kernel": (("src/repro_torch/kernels/ops.py",
                       "make_edge_dissat_fn"),),
}

CELL_ORDER = ("dense-controller", "dense-batched", "dense-distributed",
              "dense-kernel", "sparse-controller", "sparse-batched",
              "sparse-distributed", "sparse-kernel")


def _is_arm(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Name) and func.id == "isinstance":
        return len(node.args) == 2 and \
            "SparseProblem" in ast.unparse(node.args[1])
    name = func.id if isinstance(func, ast.Name) else (
        func.attr if isinstance(func, ast.Attribute) else None)
    return name == "is_sparse"


def _sparse_dispatch_sites(ctx: AnalysisContext) -> set[tuple[str, str]]:
    """(path, function) of every sparse arm: an ``isinstance(...,
    SparseProblem)`` test or an ``is_sparse(...)`` call whose value is
    used (a bare ``is_sparse(problem)`` statement only type-checks)."""
    sites: set[tuple[str, str]] = set()
    for path in _mentioning(ctx, "SparseProblem", "is_sparse"):
        for qual, fn in ctx.functions(path):
            guards = {id(s.value) for s in ast.walk(fn)
                      if isinstance(s, ast.Expr)}
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and _is_arm(node) and \
                        id(node) not in guards:
                    sites.add((path, qual))
    return sites


def _defined_functions(ctx: AnalysisContext, path: str) -> set[str]:
    try:
        return {qual for qual, _ in ctx.functions(path)}
    except FileNotFoundError:
        return set()


def dispatch_matrix(ctx: AnalysisContext) -> dict[str, dict]:
    """cell -> {"covered": bool, "missing": [what would cover it]}."""
    sites = _sparse_dispatch_sites(ctx)
    matrix: dict[str, dict] = {}
    for cell, defs in _DENSE_DEFS.items():
        missing = [f"{p}::{name}" for p, name in defs
                   if name not in _defined_functions(ctx, p)]
        matrix[cell] = {"covered": not missing, "missing": missing}
    core_missing = sorted(f"{p}::{f}" for p, f in _CORE_SPARSE_ARMS
                          if (p, f) not in sites)
    matrix["sparse-controller"] = {"covered": not core_missing,
                                   "missing": core_missing}
    batched_missing = core_missing + [
        "::".join(a) for a in _BATCH_ARMS if a not in sites]
    matrix["sparse-batched"] = {"covered": not batched_missing,
                                "missing": sorted(batched_missing)}
    dist_sites = sorted(f"{p}::{f}" for p, f in sites
                        if p.startswith("src/repro_torch/distributed/"))
    matrix["sparse-distributed"] = {
        "covered": bool(dist_sites),
        "missing": [] if dist_sites else
        ["a sparse dispatch arm (isinstance(problem, SparseProblem) or "
         "costs.is_sparse(problem)) anywhere under "
         "src/repro_torch/distributed/"]}
    return {cell: matrix[cell] for cell in CELL_ORDER}


def dispatch_findings(ctx: AnalysisContext) -> list[Finding]:
    matrix = dispatch_matrix(ctx)
    ctx.reports["dispatch-coverage"] = {"cells": matrix}
    findings = []
    for cell, info in matrix.items():
        if not info["covered"]:
            findings.append(Finding(
                rule="dispatch-coverage", key=cell,
                message=f"dispatch matrix cell {cell!r} is uncovered; "
                        f"missing: {info['missing']}"))
    for path, qual in sorted(_sparse_dispatch_sites(ctx)):
        if (path, qual) not in _REGISTERED_ARMS and \
                not path.startswith("src/repro_torch/distributed/"):
            findings.append(Finding(
                rule="dispatch-coverage", key=f"arm:{path}::{qual}",
                file=path,
                message=f"unregistered sparse dispatch arm in {qual!r} — "
                        f"register it in repro_torch.analysis.ast_rules."
                        f"_REGISTERED_ARMS so the matrix stays "
                        f"authoritative"))
    return findings


@rule("dispatch-coverage", "ast")
def _rule_dispatch(ctx: AnalysisContext) -> list[Finding]:
    """dense/sparse × runtime dispatch matrix has no unknown holes."""
    return dispatch_findings(ctx)
