"""CLI for the contract linter: ``python -m repro_torch.analysis --check``.

Runs the rule registry (all five families by default), diffs the
findings against the checked-in baseline, prints the dispatch matrix and
a findings report, and optionally dumps everything as JSON.  Exit code:
0 when every finding is baselined, 2 when NEW findings exist (only under
``--check``; without it the run is informational).

Entry points run on ``--device`` (default ``cuda``; a host without CUDA
raises rather than moving to the CPU).  ``--update-complexity`` rewrites
the ``<grid>/<device>`` section of ``complexity.json``.

The JSON report is deterministic modulo provenance and timings (findings
sorted by id, sorted keys) and stamped with the port's ``provenance()``
block.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from . import (AnalysisContext, FAMILIES, check_device, complexity_rules,
               default_baseline_path, load_baseline, registered_rules,
               run_rules, split_findings)


def _print_matrix(report: dict) -> None:
    cells = report.get("cells", {})
    if not cells:
        return
    print("\ndispatch-coverage matrix:")
    width = max(len(c) for c in cells) + 2
    for cell, info in cells.items():
        status = "covered" if info["covered"] else "MISSING"
        print(f"  {cell:<{width}}{status}")
        for m in info["missing"]:
            print(f"  {'':<{width}}  wants: {m}")


def _rewrite_baseline(path: str, entries: list[dict]) -> None:
    # dedupe on identity and keep a stable order so the file diffs cleanly
    unique = {(e["rule"], e["key"]): e for e in entries}
    ordered = [unique[k] for k in sorted(unique)]
    pathlib.Path(path).write_text(
        json.dumps({"findings": ordered}, indent=2) + "\n")


def _prune_stale(path: str, stale: set[str]) -> int:
    """Drop baseline entries no current finding matches; returns the
    number removed (the file is only rewritten when something changed)."""
    p = pathlib.Path(path)
    if not stale or not p.is_file():
        return 0
    data = json.loads(p.read_text())
    entries = data.get("findings", [])
    kept = [e for e in entries if f"{e['rule']}:{e['key']}" not in stale]
    if len(kept) != len(entries):
        _rewrite_baseline(path, kept)
    return len(entries) - len(kept)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract linter: record / AST / wire / docs / "
                    "complexity analyzers (DESIGN.md §16, §18)")
    ap.add_argument("--check", action="store_true",
                    help="exit 2 if any finding is not in the baseline")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full findings report as JSON")
    ap.add_argument("--baseline", metavar="PATH",
                    default=str(default_baseline_path()),
                    help="baseline file (default: the checked-in one)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept ALL current "
                         "findings (review the diff!); stale entries are "
                         "pruned automatically")
    ap.add_argument("--prune-stale", action="store_true",
                    help="rewrite the baseline dropping entries no "
                         "current finding matches")
    ap.add_argument("--families", nargs="+", choices=FAMILIES,
                    default=None, metavar="FAMILY",
                    help=f"run only these rule families {FAMILIES}")
    ap.add_argument("--complexity-grid", choices=sorted(
                        complexity_rules.GRIDS), default="full",
                    help="size grid for the complexity family "
                         "(default: full)")
    ap.add_argument("--update-complexity", action="store_true",
                    help="re-fit the active grid on --device and rewrite "
                         "its section of the complexity.json expectation "
                         "table")
    ap.add_argument("--complexity-table", metavar="PATH",
                    default=str(complexity_rules.default_table_path()),
                    help="expectation table written by --update-complexity "
                         "(default: the checked-in one)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the entry points run on "
                         "(default: cuda)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: autodetected)")
    args = ap.parse_args(argv)
    device = str(check_device(args.device))

    if args.update_complexity:
        path = complexity_rules.update_table(
            args.complexity_grid, args.complexity_table, device)
        section = complexity_rules.section_name(args.complexity_grid, device)
        n = len(complexity_rules.load_table(path)
                .get("grids", {}).get(section, {}))
        print(f"complexity table {path}: section {section!r} rewritten "
              f"with {n} entries")
        return 0

    ctx = AnalysisContext(repo_root=args.root,
                          complexity_grid=args.complexity_grid,
                          device=device)
    rules = registered_rules(args.families)
    t0 = time.perf_counter()
    findings = sorted(run_rules(ctx, args.families), key=lambda f: f.id)
    elapsed = time.perf_counter() - t0

    baseline = load_baseline(args.baseline)
    new, known, stale = split_findings(findings, baseline)

    fams = sorted({r.family for r in rules})
    print(f"repro_torch.analysis: {len(rules)} rules "
          f"({', '.join(fams)}) on {device} in {elapsed:.1f}s")
    if "jaxpr-zero-callback" in ctx.reports:
        eps = ctx.reports["jaxpr-zero-callback"]["entry_points"]
        print(f"  recorded entry points: {len(eps)}")
    if "sweep-compile-groups" in ctx.reports:
        r = ctx.reports["sweep-compile-groups"]
        print(f"  sweep stacking audit: {r['cases']} cases in "
              f"{r['groups']} groups, {r['violations']} violations")
    if "complexity" in ctx.reports:
        r = ctx.reports["complexity"]
        print(f"  complexity audit: {len(r['entry_points'])} entry points "
              f"fitted on {r['section']!r}")
    _print_matrix(ctx.reports.get("dispatch-coverage", {}))

    print(f"\nfindings: {len(findings)} total — {len(known)} baselined, "
          f"{len(new)} new")
    for f in known:
        print(f"  [baselined] {f.id}")
    for f in new:
        loc = f" ({f.file}:{f.line})" if f.file else ""
        print(f"  [NEW] {f.id}{loc}\n        {f.message}")
    for sid in sorted(stale):
        print(f"  [stale baseline entry] {sid}")

    if args.json:
        payload = {
            "provenance": _provenance(),
            "rules": sorted(({"name": r.name, "family": r.family,
                              "doc": r.doc} for r in rules),
                            key=lambda r: r["name"]),
            "findings": [f.to_json() for f in findings],
            "new": sorted(f.id for f in new),
            "baselined": sorted(f.id for f in known),
            "stale_baseline": sorted(stale),
            "reports": ctx.reports,
            "device": device,
            "elapsed_seconds": elapsed,
        }
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(payload, indent=2, sort_keys=True,
                                   default=str) + "\n")
        print(f"\nwrote {path}")

    if args.update_baseline:
        _rewrite_baseline(args.baseline,
                          [{"rule": f.rule, "key": f.key} for f in findings])
        print(f"baseline rewritten with "
              f"{len({f.id for f in findings})} entries")
        return 0

    if args.prune_stale:
        pruned = _prune_stale(args.baseline, stale)
        if pruned:
            print(f"pruned {pruned} stale baseline entr"
                  f"{'y' if pruned == 1 else 'ies'}")

    if args.check and new:
        print(f"\nFAIL: {len(new)} new finding(s) not in baseline "
              f"({args.baseline})")
        return 2
    return 0


def _provenance() -> dict:
    from ..provenance import provenance
    return provenance()


if __name__ == "__main__":
    sys.exit(main())
