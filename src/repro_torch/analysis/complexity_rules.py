"""complexity-family analyzers: asymptotics certification (DESIGN.md §18),
PyTorch port of ``repro.analysis.complexity_rules``.

The paper's feasibility claim is that per-round exchange is independent
of the simulated network's size (arXiv 1111.0875 §5), and the repo's
scaling story rests on asymptotic promises — O(E) sparse aggregates,
O(N*K) cost assembly, O(K) wire — that runtime benches only sample at a
few sizes.  This family certifies them over a geometric grid: every
registered entry point is rerun (set-up plus one turn, under the
recording mode of :mod:`repro_torch.analysis.entrypoints`) at each grid
size, and

  * **mem/ops budgets** — the peak single-op output bytes and an
    op-count proxy read from the record (matrix products count their
    exact FLOPs by ``launch/flops.py``'s rule for mm, bmm and addmm,
    every other op its output elements, views nothing) are fitted to
    power laws in N, K and (on sparse paths) degree; a fitted exponent
    above the budget the owning module declares (``SPARSE_COMPLEXITY``
    et al.) is a finding.  On the card a third measure rides along:
    ``mem_device``, the caching allocator's peak during the run above
    what was allocated before it, fitted against the same ``mem``
    budget.
  * **collective audit** — the collectives ``CommDebugMode`` sees are
    split into recurring (a two-turn run's bytes less a one-turn run's)
    and setup (the one-turn bytes less the recurring ones); per-shard
    operand bytes must be independent of N and equal to the declared
    ledger constants (§9.2/§14.5).
  * **expectation table** — fitted exponents and collective schedules
    are diffed against the checked-in ``complexity.json``, whose
    sections are keyed by grid and device (``quick``/``cpu`` is written
    and checked on the CPU, ``full``/``cuda`` on the card): a kernel
    launched through ``ctypes`` is not an aten op, so a kernel route's
    record differs between the card and the CPU's twin.

Findings functions take explicit inputs so the seeded-violation tests
can drive them with deliberately quadratic fixtures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
from functools import lru_cache
from typing import Callable

import numpy as np

from .registry import AnalysisContext, Finding, rule
from . import entrypoints

__all__ = [
    "Grid", "GRIDS", "EXPONENT_TOL", "EXPECTATION_TOL",
    "Measurement", "measure_jaxpr", "collective_schedule", "fit_exponent",
    "profile_trace", "profile_entry_point", "declared_budget",
    "budget_findings", "exponent_findings", "collective_findings",
    "expectation_findings", "default_table_path", "load_table",
    "build_table_entry", "update_table", "all_profiles", "section_name",
]

# A fitted exponent may exceed its declared budget by this much before
# it is a finding: absorbs padding noise (edge rounding to the padded
# edge count, max-degree growth under stitching) while staying far below
# the +1.0 jump of a genuine dense materialization on a sparse path.
EXPONENT_TOL = 0.35

# Allowed drift of a re-fitted exponent against the checked-in
# complexity.json before the regression gate fires.  Fits are exact
# shape arithmetic on the record, so same-toolchain refits reproduce
# bit-identically; the allocator's fit varies with its rounding.
EXPECTATION_TOL = 0.1


# -- size grids -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Grid:
    """One geometric sweep layout: N varied at fixed K (and fixed degree
    on sparse paths), K varied at a fixed N, degree varied at a fixed N
    (sparse only — it scales E independently of N)."""
    name: str
    n: tuple[int, ...]
    k_fixed: int
    k: tuple[int, ...]
    n_for_k: int
    degree: tuple[int, ...]
    n_for_degree: int
    degree_fixed: int = 8


GRIDS = {
    "full": Grid("full", n=(64, 256, 1024, 4096), k_fixed=4,
                 k=(2, 4, 8), n_for_k=256,
                 degree=(4, 8, 16), n_for_degree=1024),
    "quick": Grid("quick", n=(32, 64, 128, 256), k_fixed=4,
                  k=(2, 4, 8), n_for_k=64,
                  degree=(4, 8, 16), n_for_degree=128),
}


def section_name(grid_name: str, device) -> str:
    """The expectation table's section for a grid on a device:
    ``"quick/cpu"``, ``"full/cuda"``."""
    return f"{grid_name}/{str(device).split(':')[0]}"


# -- record measurement -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Measurement:
    """Byte/op profile of one recorded run."""
    peak_bytes: int          # largest single op output (views excluded)
    peak_shape: tuple        # its shape (the "(N, N) intermediate" story)
    peak_primitive: str      # its aten op
    arg_bytes: int           # the run's input tensors
    ops: int                 # element-count proxy; matmuls counted exactly
    mem_device: int | None = None   # allocator peak above the start (card)


def measure_jaxpr(record) -> Measurement:
    """Walk every op of a record and take the peak output and the
    op-count proxy — a scaling proxy, not a cost model (the fits only
    need exponents).  The reference's name is kept."""
    peak, peak_shape, peak_prim, ops = 0, (), "", 0
    for op in record.ops:
        ops += op.count
        if op.out_bytes > peak:
            peak = op.out_bytes
            peak_shape = op.shapes[0] if op.shapes else ()
            peak_prim = op.name
    return Measurement(peak_bytes=peak, peak_shape=tuple(peak_shape),
                       peak_primitive=peak_prim, arg_bytes=record.arg_bytes,
                       ops=ops, mem_device=record.mem_device)


def collective_schedule(one_turn, two_turns
                        ) -> tuple[tuple[str, str, int], ...]:
    """The collectives of a run as (kind, phase, per-shard operand
    bytes): the events a second turn adds are "recurring" (once per
    refinement round), the ones before them "setup"."""
    first = list(one_turn.collectives)
    extra = list(two_turns.collectives)[len(first):]
    setup = first[:len(first) - len(extra)]
    return tuple([(kind, "setup", b) for kind, b in setup]
                 + [(kind, "recurring", b) for kind, b in extra])


# -- power-law fitting ------------------------------------------------------

def fit_exponent(sizes, values) -> float:
    """Least-squares slope of log2(value) against log2(size): the fitted
    exponent of the best power law through the grid points."""
    xs = np.log2(np.asarray(sizes, dtype=np.float64))
    ys = np.log2(np.maximum(np.asarray(values, dtype=np.float64), 1.0))
    if xs.size < 2 or np.ptp(xs) == 0.0:
        return 0.0
    a = np.stack([xs, np.ones_like(xs)], axis=1)
    slope = np.linalg.lstsq(a, ys, rcond=None)[0][0]
    return float(slope)


def _fits(sizes, meas: list[Measurement], device_mem: bool) -> dict:
    out = {"mem": fit_exponent(sizes, [m.peak_bytes for m in meas]),
           "ops": fit_exponent(sizes, [m.ops for m in meas])}
    if device_mem:
        out["mem_device"] = fit_exponent(sizes,
                                         [m.mem_device for m in meas])
    return out


def profile_trace(trace_fn: Callable[..., object], grid: Grid, *,
                  sparse: bool = False, max_n: int | None = None,
                  collectives: bool = False) -> dict:
    """Fit the mem/ops (and, from records that carry it, mem_device)
    exponents of ``trace_fn(n, k, degree[, turns])`` over a grid, and
    summarize its collective schedule across the N sweep.

    ``trace_fn`` returns a :class:`~repro_torch.analysis.entrypoints.
    Record`; with ``collectives=True`` it is also called with
    ``turns=2`` at every N for the recurring collectives.  Returns
    ``{"fits": {"mem": {dim: exp}, "ops": {...}[, "mem_device": ...]},
    "peak_shape", "peak_primitive", "sizes", "mem_device_bytes",
    "collectives": {"n_independent", "recurring_bytes", "setup_bytes",
    "schedule"}}``.  The seeded-violation tests call this directly with
    fixture trace functions.
    """
    deg = grid.degree_fixed if sparse else None
    ns = tuple(n for n in grid.n if max_n is None or n <= max_n)
    n_recs = [trace_fn(n, grid.k_fixed, deg) for n in ns]
    n_meas = [measure_jaxpr(r) for r in n_recs]
    if collectives:
        scheds = [collective_schedule(r, trace_fn(n, grid.k_fixed, deg,
                                                  turns=2))
                  for n, r in zip(ns, n_recs)]
    else:
        scheds = [collective_schedule(r, r) for r in n_recs]
    device_mem = all(m.mem_device is not None for m in n_meas)

    n_for_k = min((grid.n_for_k, *(m for m in (max_n,) if m is not None)))
    k_meas = [measure_jaxpr(trace_fn(n_for_k, k, deg)) for k in grid.k]

    by_dim = {"n": _fits(ns, n_meas, device_mem),
              "k": _fits(grid.k, k_meas, device_mem)}
    sizes = {"n": list(ns), "k": list(grid.k)}
    mem_dev = {"n": [m.mem_device for m in n_meas],
               "k": [m.mem_device for m in k_meas]}
    if sparse:
        n_for_d = min((grid.n_for_degree,
                       *(m for m in (max_n,) if m is not None)))
        d_meas = [measure_jaxpr(trace_fn(n_for_d, grid.k_fixed, d))
                  for d in grid.degree]
        by_dim["e"] = _fits(grid.degree, d_meas, device_mem)
        sizes["e"] = list(grid.degree)
        mem_dev["e"] = [m.mem_device for m in d_meas]
    fits = {metric: {dim: f[metric] for dim, f in by_dim.items()}
            for metric in by_dim["n"]}

    top = n_meas[-1]
    return {
        "fits": fits,
        "peak_shape": top.peak_shape,
        "peak_primitive": top.peak_primitive,
        "sizes": sizes,
        "mem_device_bytes": mem_dev if device_mem else None,
        "collectives": {
            "n_independent": all(s == scheds[0] for s in scheds),
            "recurring_bytes": sum(b for _, ph, b in scheds[-1]
                                   if ph == "recurring"),
            "setup_bytes": sum(b for _, ph, b in scheds[-1]
                               if ph == "setup"),
            "schedule": scheds[-1],
        },
    }


@lru_cache(maxsize=None)
def profile_entry_point(name: str, grid_name: str,
                        device: str = "cuda") -> dict:
    """Grid profile of a registered entry point on ``device`` (cached per
    process — the CLI, the card script and the test suite share the
    work)."""
    ep = entrypoints.entry_point(name)

    def trace(n, k, degree, turns=1):
        return entrypoints.trace_entry_point_sized(name, n, k, degree,
                                                   device, turns)
    session = ep.session(device) if ep.session is not None \
        else contextlib.nullcontext()
    with session:
        return profile_trace(trace, GRIDS[grid_name],
                             sparse=(ep.rep == "sparse"), max_n=ep.max_n,
                             collectives=(ep.runtime == "distributed"))


# -- declared budgets -------------------------------------------------------

_ZERO_COLLECTIVES = {"recurring_bytes": 0, "setup_bytes": 0}


def _module_attr(modname: str, attr: str):
    import importlib
    return getattr(importlib.import_module(modname), attr, None)


def declared_budget(ep) -> dict | None:
    """The complexity budget the owning module declares for ``ep``, or
    None when nothing is declared (a finding: every registered entry
    point must carry a budget).

    Budgets live next to the code they constrain — ``SPARSE_COMPLEXITY``
    beside the edge-list layout, ``KERNEL_COMPLEXITY`` beside the kernel
    adapters, ``DISTRIBUTED_COLLECTIVES`` beside the drivers — the same
    ownership rule as the §16.4 dispatch arms.
    """
    kernel = _module_attr("repro_torch.kernels.ops",
                          "KERNEL_COMPLEXITY") or {}
    if ep.name in kernel:
        base = kernel[ep.name]
    elif ep.runtime == "des":
        base = _module_attr("repro_torch.des.engine", "DES_COMPLEXITY")
    elif ep.runtime == "distributed":
        base = _module_attr("repro_torch.distributed.runtime",
                            "DISTRIBUTED_COMPLEXITY")
    elif ep.rep == "sparse":
        base = _module_attr("repro_torch.core.sparse", "SPARSE_COMPLEXITY")
    else:
        base = _module_attr("repro_torch.core.costs", "DENSE_COMPLEXITY")
    if base is None:
        return None
    coll = _ZERO_COLLECTIVES
    if ep.runtime == "distributed":
        table = _module_attr("repro_torch.distributed.runtime",
                             "DISTRIBUTED_COLLECTIVES") or {}
        coll = table.get(ep.name)
        if coll is None:
            return None
    return {"mem": dict(base["mem"]), "ops": dict(base["ops"]),
            "collectives": dict(coll)}


# -- findings ---------------------------------------------------------------

def budget_findings(eps, lookup: Callable = declared_budget) -> list[Finding]:
    out = []
    for ep in eps:
        if lookup(ep) is None:
            out.append(Finding(
                "complexity-budget-declared", ep.name,
                f"entry point {ep.name!r} ({ep.runtime}/{ep.rep}) has no "
                f"declared complexity budget — add it to the owning "
                f"module's *_COMPLEXITY registry (DESIGN.md §18)"))
    return out


def exponent_findings(name: str, profile: dict, budget: dict, metric: str,
                      tol: float = EXPONENT_TOL) -> list[Finding]:
    """Fitted exponents of ``metric`` ("mem", "ops" or "mem_device")
    against the budget ("mem_device" is held to the "mem" budget)."""
    out = []
    rule_name = ("complexity-ops-budget" if metric == "ops"
                 else "complexity-mem-budget")
    limits = budget["ops" if metric == "ops" else "mem"]
    suffix = "" if metric != "mem_device" else ":device"
    for dim, fitted in sorted(profile["fits"].get(metric, {}).items()):
        limit = limits.get(dim)
        if limit is None or fitted <= limit + tol:
            continue
        shape = profile.get("peak_shape", ())
        prim = profile.get("peak_primitive", "")
        hint = (f"; peak intermediate {tuple(shape)} from {prim!r}"
                if metric == "mem" and shape else "")
        out.append(Finding(
            rule_name, f"{name}:{dim}{suffix}",
            f"{name}: fitted {metric} exponent {fitted:.2f} in {dim!r} "
            f"exceeds declared budget {limit:.2f} (+{tol} tolerance)"
            f"{hint}"))
    return out


def collective_findings(name: str, coll: dict, declared: dict) -> list[Finding]:
    """The collective schedule against the declared per-round ledger:
    N-independence plus exact recurring/setup per-shard byte totals."""
    out = []
    if not coll["n_independent"]:
        out.append(Finding(
            "complexity-collectives", f"{name}:n-dependent",
            f"{name}: collective schedule changes across the N grid — "
            f"per-round exchange must be independent of network size "
            f"(arXiv 1111.0875 §5); top-size schedule: "
            f"{list(coll['schedule'])}"))
    for phase in ("recurring", "setup"):
        got, want = coll[f"{phase}_bytes"], declared[f"{phase}_bytes"]
        if got != want:
            out.append(Finding(
                "complexity-collectives", f"{name}:{phase}-bytes",
                f"{name}: {phase} collective operand bytes {got} != "
                f"declared ledger constant {want} (§9.2/§14.5); "
                f"schedule: {list(coll['schedule'])}"))
    return out


# -- expectation table (complexity.json) ------------------------------------

def default_table_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "complexity.json"


def load_table(path: pathlib.Path | str | None = None) -> dict:
    p = pathlib.Path(path) if path else default_table_path()
    if not p.is_file():
        return {}
    return json.loads(p.read_text())


def build_table_entry(profile: dict) -> dict:
    coll = profile["collectives"]
    return {
        "fits": {m: {d: round(v, 3) for d, v in sorted(dims.items())}
                 for m, dims in sorted(profile["fits"].items())},
        "peak_shape": list(profile["peak_shape"]),
        "peak_primitive": profile["peak_primitive"],
        "collectives": {
            "n_independent": coll["n_independent"],
            "recurring_bytes": coll["recurring_bytes"],
            "setup_bytes": coll["setup_bytes"],
            "schedule": [list(c) for c in coll["schedule"]],
        },
    }


def expectation_findings(profiles: dict, table: dict, section: str,
                         tol: float = EXPECTATION_TOL) -> list[Finding]:
    """Diff re-fitted exponents and collective schedules against the
    checked-in expectation table's ``section`` (``"quick/cpu"``,
    ``"full/cuda"``) — the cross-PR regression gate."""
    out = []
    grid_tab = table.get("grids", {}).get(section)
    if grid_tab is None:
        out.append(Finding(
            "complexity-expectations", f"table:{section}",
            f"complexity.json has no expectation entries for "
            f"{section!r} — regenerate with --update-complexity"))
        return out
    for name, prof in sorted(profiles.items()):
        exp = grid_tab.get(name)
        if exp is None:
            out.append(Finding(
                "complexity-expectations", f"missing:{name}",
                f"{name}: no expectation entry for {section!r} — "
                f"regenerate with --update-complexity"))
            continue
        for metric, dims in sorted(prof["fits"].items()):
            for dim, fitted in sorted(dims.items()):
                want = exp.get("fits", {}).get(metric, {}).get(dim)
                if want is None or abs(fitted - want) > tol:
                    out.append(Finding(
                        "complexity-expectations",
                        f"{name}:{metric}.{dim}",
                        f"{name}: fitted {metric} exponent in {dim!r} is "
                        f"{fitted:.3f}, expectation table says {want} "
                        f"(drift tolerance {tol})"))
        got_c = build_table_entry(prof)["collectives"]
        want_c = exp.get("collectives")
        if got_c != want_c:
            out.append(Finding(
                "complexity-expectations", f"{name}:collectives",
                f"{name}: collective schedule {got_c} != expectation "
                f"table entry {want_c}"))
    for name in sorted(set(grid_tab) - set(profiles)):
        out.append(Finding(
            "complexity-expectations", f"stale:{name}",
            f"expectation table entry {name!r} matches no registered "
            f"entry point — regenerate with --update-complexity"))
    return out


def update_table(grid_name: str, path: pathlib.Path | str | None = None,
                 device: str = "cuda") -> pathlib.Path:
    """Re-fit every budgeted entry point on ``grid_name`` on ``device``
    and rewrite that section of complexity.json (other sections
    preserved)."""
    p = pathlib.Path(path) if path else default_table_path()
    table = load_table(p)
    table.setdefault("grids", {})
    profiles = all_profiles(grid_name, device)
    table["grids"][section_name(grid_name, device)] = {
        name: build_table_entry(prof)
        for name, prof in sorted(profiles.items())}
    p.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    return p


# -- rule wiring ------------------------------------------------------------

def all_profiles(grid_name: str, device: str = "cuda") -> dict:
    """name -> grid profile for every entry point with a declared budget
    (budget-less entries are the budget rule's findings, not crashes)."""
    return {ep.name: profile_entry_point(ep.name, grid_name, device)
            for ep in entrypoints.registered_entry_points()
            if declared_budget(ep) is not None}


def _ctx_profiles(ctx: AnalysisContext) -> tuple[str, dict]:
    grid_name = getattr(ctx, "complexity_grid", "full")
    profiles = all_profiles(grid_name, str(ctx.device))
    ctx.reports.setdefault("complexity", {
        "grid": grid_name,
        "section": section_name(grid_name, ctx.device),
        "entry_points": {name: build_table_entry(prof)
                         for name, prof in sorted(profiles.items())},
        "mem_device_bytes": {name: prof["mem_device_bytes"]
                             for name, prof in sorted(profiles.items())
                             if prof["mem_device_bytes"] is not None},
    })
    return grid_name, profiles


@rule("complexity-budget-declared", "complexity")
def complexity_budget_declared(ctx: AnalysisContext) -> list[Finding]:
    """Every registered entry point must carry a declared budget."""
    return budget_findings(entrypoints.registered_entry_points())


@rule("complexity-mem-budget", "complexity")
def complexity_mem_budget(ctx: AnalysisContext) -> list[Finding]:
    """Peak-bytes exponents (record and allocator) within the budgets."""
    _, profiles = _ctx_profiles(ctx)
    out = []
    for name, prof in sorted(profiles.items()):
        budget = declared_budget(entrypoints.entry_point(name))
        out.extend(exponent_findings(name, prof, budget, "mem"))
        out.extend(exponent_findings(name, prof, budget, "mem_device"))
    return out


@rule("complexity-ops-budget", "complexity")
def complexity_ops_budget(ctx: AnalysisContext) -> list[Finding]:
    """Op-count exponents within the declared budgets."""
    _, profiles = _ctx_profiles(ctx)
    out = []
    for name, prof in sorted(profiles.items()):
        budget = declared_budget(entrypoints.entry_point(name))
        out.extend(exponent_findings(name, prof, budget, "ops"))
    return out


@rule("complexity-collectives", "complexity")
def complexity_collectives(ctx: AnalysisContext) -> list[Finding]:
    """Collective schedules: N-independent, matching ledger constants."""
    _, profiles = _ctx_profiles(ctx)
    out = []
    for name, prof in sorted(profiles.items()):
        budget = declared_budget(entrypoints.entry_point(name))
        out.extend(collective_findings(name, prof["collectives"],
                                       budget["collectives"]))
    return out


@rule("complexity-expectations", "complexity")
def complexity_expectations(ctx: AnalysisContext) -> list[Finding]:
    """Fitted exponents agree with the checked-in complexity.json."""
    grid_name, profiles = _ctx_profiles(ctx)
    return expectation_findings(profiles, load_table(),
                                section_name(grid_name, ctx.device))
