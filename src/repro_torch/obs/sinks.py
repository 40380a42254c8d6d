"""Telemetry sinks: JSONL run logs and Chrome-trace export (DESIGN.md §14.2).

A sink is any object with ``write(event: dict)`` and optional
``flush()`` / ``close()``; the :class:`~repro.obs.recorder.Recorder`
fans every emitted event out to all attached sinks.  Two concrete sinks
ship here — :class:`MemorySink` (in-process list, used by tests and the
replay helpers) and :class:`JsonlSink` (one JSON object per line, the
on-disk run-log format the report CLI consumes) — plus
:func:`chrome_trace`, which converts the ``phase`` events of a run log
into the Chrome ``traceEvents`` JSON that chrome://tracing and Perfetto
load directly.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import IO, Iterable

from .events import validate_event


class MemorySink:
    """Collects events in a list (``sink.events``)."""

    def __init__(self):
        self.events: list[dict] = []

    def write(self, event: dict) -> None:
        self.events.append(event)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends one compact JSON object per event to ``path``."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh: IO[str] = open(self.path, "a", encoding="utf-8")

    def write(self, event: dict) -> None:
        self._fh.write(json.dumps(event, separators=(",", ":")) + "\n")

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path, validate: bool = True) -> list[dict]:
    """Load a JSONL run log back into event dicts (blank lines skipped)."""
    events = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            event = json.loads(line)
            if validate:
                validate_event(event)
            events.append(event)
    return events


def chrome_trace(events: Iterable[dict]) -> dict:
    """Convert ``phase`` events to Chrome trace format (``traceEvents``).

    Each phase becomes one complete (``ph: "X"``) slice; runs map to
    trace *threads* so concurrent runs in one log stay visually
    separated.  Timestamps are microseconds relative to the earliest
    phase in the log, as the trace viewers expect.
    """
    phases = [e for e in events if e.get("kind") == "phase"]
    t0 = min((e["ts"] for e in phases), default=0.0)
    runs = sorted({e["run"] for e in phases})
    tids = {run: i for i, run in enumerate(runs)}
    trace_events = [{
        "name": e["name"],
        "ph": "X",
        "ts": (e["ts"] - t0) * 1e6,
        "dur": max(e["dur"], 0.0) * 1e6,
        "pid": 0,
        "tid": tids[e["run"]],
        "args": {"run": e["run"]},
    } for e in phases]
    trace_events.extend({
        "name": "thread_name",
        "ph": "M",
        "pid": 0,
        "tid": tid,
        "args": {"name": run},
    } for run, tid in tids.items())
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Iterable[dict], path) -> Path:
    """Write :func:`chrome_trace` output to ``path`` (returns the path)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(events), indent=1))
    return path
