"""Replay + report CLI for telemetry run logs (DESIGN.md §14.4), PyTorch
port of ``repro.obs.report`` (the log format is the reference's, so each
package's CLI reads the other's logs).

``python -m repro_torch.obs.report RUN.jsonl`` renders per-run convergence /
load-CV / wire summaries from a JSONL log alone — no device, no problem
arrays.  The core is :func:`replay_run`: starting from the ``run_start``
machine loads it re-applies every accepted move's ``(source, dest,
weight)``, reconstructing the weighted-load CV descent trace and the
final loads, and collects the carried potential trace from the ``turn``/
``sweep`` events.  :func:`check_run` then cross-checks the replay
against the ``run_end`` ground truth (final loads, move count), verifies
potential descent for sequential runs, and enforces the ``wire`` and
``drift`` verdicts — ``--check`` exits nonzero on any failure, which is
what the CI bench-smoke job gates on.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from .sinks import read_jsonl

SEQUENTIAL_RUNTIMES = {"refine", "refine_traced", "distributed",
                       "distributed_traced", "shard_map"}
# f32 potentials are O(1e6) sums; allow this relative slack before calling
# a carried-potential ascent a descent violation.
ASCENT_REL_TOL = 1e-5


def split_runs(events) -> dict[str, list[dict]]:
    """Group a log's events by run id, preserving order."""
    runs: dict[str, list[dict]] = {}
    for event in events:
        runs.setdefault(event["run"], []).append(event)
    return runs


def _cv(loads: np.ndarray, speeds: np.ndarray) -> float:
    weighted = loads / speeds
    mean = weighted.mean()
    return float(weighted.std() / max(mean, 1e-12))


def replay_run(events: list[dict]) -> dict:
    """Reconstruct one run's traces from its event stream alone.

    Returns a summary dict with the replayed ``loads`` / ``load_cv`` /
    ``cv_trace``, the potential trace ``potentials`` (list of ``(t, c0,
    ct0)`` for turns/sweeps that carry them), accept/reject counters,
    and the raw ``wire`` / ``drift`` / ``run_end`` events for checking.
    """
    start = next((e for e in events if e["kind"] == "run_start"), None)
    if start is None:
        raise ValueError("run has no run_start event")
    summary: dict = {
        "run": start["run"],
        "runtime": start["runtime"],
        "meta": {k: v for k, v in start.items()
                 if k not in ("kind", "run", "loads", "speeds")},
    }
    loads = np.asarray(start.get("loads", []), np.float64)
    speeds = np.asarray(start.get("speeds", np.ones_like(loads)), np.float64)
    cv_trace: list[float] = []
    potentials: list[tuple] = []
    accepted = 0
    rejects: dict[str, int] = {}
    movers = 0
    ticks = 0
    des_refines = 0
    frozen_max = 0
    segments: set[int] = set()
    for event in events:
        kind = event["kind"]
        if kind == "turn":
            if event["moved"]:
                accepted += 1
                if loads.size:
                    loads[event["source"]] -= event["weight"]
                    loads[event["dest"]] += event["weight"]
            else:
                reason = event.get("reject") or "unknown"
                rejects[reason] = rejects.get(reason, 0) + 1
            if loads.size:
                cv_trace.append(_cv(loads, speeds))
            if event.get("c0") is not None:
                potentials.append((event["t"], event["c0"], event["ct0"]))
        elif kind == "sweep":
            movers += max(event["movers"], 0)
            potentials.append((event["t"], event["c0"], event["ct0"]))
        elif kind == "tick":
            ticks += 1
            segments.add(event["segment"])
            frozen_max = max(frozen_max, event["frozen"])
        elif kind == "des_refine":
            des_refines += 1
    fault_counts: dict[str, int] = {}
    retries = 0
    undelivered = 0
    max_lag = 0
    quarantined = 0
    for event in events:
        kind = event["kind"]
        if kind == "fault_injected":
            fault_counts[event["fault"]] = \
                fault_counts.get(event["fault"], 0) + 1
        elif kind == "exchange_retry":
            retries += event["attempts"]
            undelivered += 0 if event["delivered"] else 1
        elif kind == "staleness":
            max_lag = max(max_lag, event["lag"])
            quarantined += 1 if event["quarantined"] else 0
    summary.update(
        faults=fault_counts, retries=retries, undelivered=undelivered,
        max_lag=max_lag, quarantined=quarantined,
        repairs=[e for e in events if e["kind"] == "repair"],
        aborted=next((e for e in events if e["kind"] == "run_aborted"),
                     None),
    )
    summary.update(
        accepted=accepted, rejects=rejects, movers=movers,
        loads=loads, load_cv=_cv(loads, speeds) if loads.size else None,
        cv_trace=np.asarray(cv_trace), potentials=potentials,
        ticks=ticks, des_refines=des_refines, frozen_max=frozen_max,
        segments=sorted(segments),
        wire=[e for e in events if e["kind"] == "wire"],
        drift=[e for e in events if e["kind"] == "drift"],
        end=next((e for e in events if e["kind"] == "run_end"), None),
        phases=[e for e in events if e["kind"] == "phase"],
    )
    return summary


def check_run(summary: dict) -> list[str]:
    """Cross-check a replayed run; returns a list of failure strings."""
    problems: list[str] = []
    run = summary["run"]
    end = summary["end"]
    faulty = bool(summary["meta"].get("faults")) or bool(summary["faults"])
    had_turns = summary["accepted"] + sum(summary["rejects"].values()) > 0
    if summary["aborted"] is not None:
        problems.append(f"{run}: run aborted — {summary['aborted']['error']}")
    if faulty:
        # Recover-or-raise verdict (DESIGN.md §15): a fault-injected run
        # must close with an explicit recovered=True.
        if end is None:
            problems.append(f"{run}: fault-injected run has no run_end")
        elif not end.get("recovered", False):
            drift = end.get("recovery_drift")
            problems.append(
                f"{run}: fault-injected run did not recover "
                f"(recovery drift {drift if drift is not None else '?'})")
    if end is not None and summary["loads"].size and had_turns:
        end_loads = np.asarray(end.get("loads", []), np.float64)
        if end_loads.size and not np.allclose(
                summary["loads"], end_loads, rtol=1e-5, atol=1e-3):
            problems.append(
                f"{run}: replayed final loads disagree with run_end "
                f"(max |Δ| = {np.abs(summary['loads'] - end_loads).max():g})")
    if (end is not None and "num_moves" in end
            and summary["runtime"] != "sweep"
            and (summary["accepted"] or summary["movers"])):
        replayed = summary["accepted"] + summary["movers"]
        if replayed != end["num_moves"]:
            problems.append(f"{run}: replayed {replayed} moves, run_end "
                            f"reports {end['num_moves']}")
    # Degraded-mode moves elected on stale aggregates (and repair jumps)
    # may transiently ascend — the recover-or-raise verdict above is the
    # fault-injected run's correctness gate, not strict descent.
    if summary["runtime"] in SEQUENTIAL_RUNTIMES and not faulty:
        pots = summary["potentials"]
        for (t0, c0a, _), (t1, c0b, _) in zip(pots, pots[1:]):
            if c0b - c0a > ASCENT_REL_TOL * abs(c0a) and not math.isnan(c0b):
                problems.append(f"{run}: carried C_0 ascends at turn {t1} "
                                f"({c0a:g} -> {c0b:g})")
                break
    for event in summary["wire"]:
        if not event["ok"]:
            problems.append(
                f"{run}: measured wire bytes disagree with ledger "
                f"(payload {event['measured_payload']} vs "
                f"{event['predicted_payload']}, setup "
                f"{event['measured_setup']} vs {event['predicted_setup']})")
    for event in summary["drift"]:
        if event["value"] > event["budget"]:
            problems.append(f"{run}: aggregate drift {event['value']:g} "
                            f"exceeds budget {event['budget']:g}")
    return problems


def render(summary: dict) -> str:
    """One human-readable block per run."""
    lines = [f"run {summary['run']}  [{summary['runtime']}]"]
    meta = summary["meta"]
    known = {k: meta[k] for k in ("framework", "n", "k", "num_shards")
             if k in meta}
    if known:
        lines.append("  " + "  ".join(f"{k}={v}" for k, v in known.items()))
    if summary["accepted"] or summary["rejects"]:
        rej = ", ".join(f"{k}:{v}" for k, v in sorted(
            summary["rejects"].items())) or "none"
        lines.append(f"  turns: {summary['accepted']} accepted, "
                     f"rejected {{{rej}}}")
    if summary["movers"]:
        lines.append(f"  sweeps: {summary['movers']} total movers")
    pots = summary["potentials"]
    if pots:
        lines.append(f"  potential C_0: {pots[0][1]:.6g} -> {pots[-1][1]:.6g}"
                     f"  (Ct_0 {pots[0][2]:.6g} -> {pots[-1][2]:.6g})")
    if summary["cv_trace"].size:
        lines.append(f"  load CV: {summary['cv_trace'][0]:.4f} -> "
                     f"{summary['cv_trace'][-1]:.4f}")
    if summary["ticks"]:
        lines.append(f"  des: {summary['ticks']} ticks, "
                     f"{summary['des_refines']} refine rounds, "
                     f"max frozen {summary['frozen_max']}, "
                     f"segments {summary['segments']}")
    for event in summary["wire"]:
        verdict = "OK" if event["ok"] else "MISMATCH"
        lines.append(f"  wire [{verdict}]: {event['rounds']} rounds, "
                     f"payload {event['measured_payload']} B measured / "
                     f"{event['predicted_payload']} B predicted, setup "
                     f"{event['measured_setup']} / "
                     f"{event['predicted_setup']} B")
    for event in summary["drift"]:
        lines.append(f"  drift: {event['value']:g} (budget "
                     f"{event['budget']:g})")
    if summary["faults"]:
        injected = ", ".join(f"{k}:{v}" for k, v in
                             sorted(summary["faults"].items()))
        lines.append(f"  faults: {{{injected}}}, {summary['retries']} "
                     f"retry attempts ({summary['undelivered']} given up), "
                     f"max staleness {summary['max_lag']}, "
                     f"{summary['quarantined']} quarantined shard-rounds")
    if summary["repairs"]:
        cols = sum(e["cols"] or 0 for e in summary["repairs"])
        drifts = [e["drift"] for e in summary["repairs"]
                  if e["drift"] is not None]
        worst = f", worst drift {max(drifts):g}" if drifts else ""
        lines.append(f"  repairs: {len(summary['repairs'])} "
                     f"({cols} columns patched{worst})")
    if summary["aborted"] is not None:
        lines.append(f"  ABORTED: {summary['aborted']['error']}")
    end = summary["end"]
    if end is not None:
        extra = f", wall {end['wall']:.3f}s" if "wall" in end else ""
        if "recovered" in end:
            verdict = "recovered" if end["recovered"] else "NOT RECOVERED"
            rd = end.get("recovery_drift")
            extra += f", {verdict}" + \
                (f" (drift {rd:g})" if rd is not None else "")
        lines.append(f"  end: moves={end.get('num_moves')} "
                     f"turns={end.get('num_turns')} "
                     f"converged={end.get('converged')}{extra}")
    if summary["phases"]:
        total = sum(e["dur"] for e in summary["phases"])
        lines.append(f"  phases: {len(summary['phases'])} spans, "
                     f"{total:.3f}s total")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render convergence/CV/wire summaries from a telemetry "
                    "JSONL run log.")
    parser.add_argument("logs", nargs="+",
                        help="path(s) to JSONL run logs")
    parser.add_argument("--check", action="store_true",
                        help="exit nonzero on wire mismatch, drift over "
                             "budget, replay disagreement, or potential "
                             "ascent")
    parser.add_argument("--json", action="store_true",
                        help="emit machine-readable per-run summaries")
    parser.add_argument("--trace", default=None, metavar="OUT.json",
                        help="also write the logs' phase spans as a "
                             "Chrome/Perfetto trace")
    args = parser.parse_args(argv)

    # run ids are per-recorder (r0000, r0001, ...), so distinct logs can
    # reuse them — namespace by log file when reporting several at once
    # or the replays would merge unrelated runs.
    events = []
    for log in args.logs:
        batch = read_jsonl(log)
        if len(args.logs) > 1:
            stem = os.path.splitext(os.path.basename(log))[0]
            for event in batch:
                event["run"] = f"{stem}:{event['run']}"
        events.extend(batch)
    if args.trace:
        from .sinks import write_chrome_trace
        write_chrome_trace(events, args.trace)
    runs = split_runs(events)
    if not runs:
        print("empty log")
        return 1 if args.check else 0
    failures: list[str] = []
    for run_events in runs.values():
        summary = replay_run(run_events)
        if args.json:
            payload = {k: v for k, v in summary.items()
                       if k not in ("cv_trace", "loads", "phases")}
            payload["cv_first"] = (float(summary["cv_trace"][0])
                                   if summary["cv_trace"].size else None)
            payload["cv_last"] = (float(summary["cv_trace"][-1])
                                  if summary["cv_trace"].size else None)
            print(json.dumps(payload, default=str))
        else:
            print(render(summary))
        failures.extend(check_run(summary))
    if failures:
        print("\nCHECK FAILURES:", file=sys.stderr)
        for failure in failures:
            print(f"  {failure}", file=sys.stderr)
    return 1 if (args.check and failures) else 0


if __name__ == "__main__":
    sys.exit(main())
