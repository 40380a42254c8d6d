"""Typed telemetry event schema (DESIGN.md §14.1).

Every event is a flat JSON-serializable dict with two mandatory keys —
``kind`` (one of :data:`EVENT_KINDS`) and ``run`` (the recorder-assigned
run id) — plus the kind's required fields below and any number of
optional extras.  Field values are plain Python scalars / lists by the
time they reach a sink; :func:`make_event` normalizes numpy/JAX scalars.

Kinds
-----
``run_start``
    Opens a run.  ``runtime`` names the entry point (``refine``,
    ``refine_traced``, ``refine_simultaneous``, ``distributed``,
    ``distributed_traced``, ``distributed_simultaneous``, ``shard_map``,
    ``des``, ``sweep``); ``loads`` carries the initial (K,) machine
    loads and ``speeds`` the (K,) machine speeds so the report CLI can
    replay weighted-load CV from the move stream alone.
``turn``
    One sequential refinement turn.  ``moved`` is the accept bit; on
    acceptance ``node``/``source``/``dest``/``gain``/``weight`` describe
    the move; on rejection ``reject`` classifies it (``"hysteresis"``
    when the raw best gain cleared ``tol`` but the θ-netted gain did
    not, else ``"satisfied"``).  ``c0``/``ct0`` are the carried global
    potentials *after* the turn (NaN when the variant does not carry
    them).  ``batch`` tags the sweep element for vmapped runs.
``sweep``
    One §4.5 simultaneous sweep: ``movers`` nodes moved, post-sweep
    potentials, ``active`` mirrors the trace's activity bit.
``tick``
    One DES tick at the engine's ``trace_stride`` cadence: committed
    ``gvt``, cumulative ``processed``/``rollbacks``/``refines``/
    ``moves``, mean backlog ``mean_len``, per-machine weighted-load CV
    ``wload_cv``, current speed-schedule ``segment`` (-1 when no
    schedule), and ``frozen`` migration-frozen LPs.
``des_refine``
    One in-situ repartition round: ``moves`` accepted this round,
    ``frozen`` LPs pinned by the migration freeze.
``wire``
    Measured-vs-predicted exchange bytes for a distributed run:
    ``rounds``, ``measured_payload``/``predicted_payload`` (per-turn
    candidate + trace partials), ``measured_setup``/``predicted_setup``,
    and the reconciliation verdict ``ok``.
``drift``
    Carried-vs-recomputed aggregate drift (``RefineResult
    .aggregate_drift``) against the standing ``budget``.
``phase``
    Wall-clock span: ``name``, start ``ts`` and duration ``dur`` in
    seconds (exported to Chrome trace / Perfetto by the sinks).
``element``
    Per-batch-element reduction of a sweep/fleet: the §12.5 headline
    stats for element ``batch``.
``fault_injected``
    One injected fault (DESIGN.md §15): round ``t``, target ``shard``,
    and the ``fault`` class (``"down"``, ``"omit"``, ``"lost"``,
    ``"dup"``, ``"corrupt"``).
``exchange_retry``
    A candidate exchange lost on the wire at round ``t``: the sender
    ``shard``, how many bounded ``attempts`` the retry loop spent, and
    whether the candidate was ultimately ``delivered`` (else the round
    proceeds without it, stale).
``staleness``
    A shard acting on an out-of-date aggregate: round ``t``, ``shard``,
    its staleness ``lag`` (rounds since the last accepted exchange),
    and whether the bounded-staleness rule has ``quarantined`` it
    (lag > max_staleness, DESIGN.md §15.2).
``repair``
    One self-healing repair action: round ``t``, ``action``
    (``"column"`` for an in-run column repair, ``"audit"`` for the
    end-of-run reconciliation), the observed pre-repair ``drift``, and
    the number of aggregate ``cols`` patched (both ``None`` when the
    driver only knows the repair schedule, not its measurements).
``run_aborted``
    Terminal event flushed when the wrapped run raised before its
    events could be finalized (recorder ``finally`` path): ``error``
    is the exception's ``repr``.
``run_end``
    Closes a run with the final counters and, when available, final
    potentials and loads.  Fault-injected runs add ``recovered`` and
    ``recovery_drift`` (the recover-or-raise verdict, DESIGN.md §15).
"""
from __future__ import annotations

from typing import Any

EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "run_start": ("runtime",),
    "turn": ("t", "moved", "c0", "ct0"),
    "sweep": ("t", "movers", "c0", "ct0", "active"),
    "tick": ("t", "gvt", "processed", "rollbacks", "refines", "moves",
             "mean_len", "wload_cv", "segment", "frozen"),
    "des_refine": ("t", "moves", "frozen"),
    "wire": ("rounds", "measured_payload", "predicted_payload",
             "measured_setup", "predicted_setup", "ok"),
    "drift": ("value", "budget"),
    "phase": ("name", "ts", "dur"),
    "element": ("batch",),
    "fault_injected": ("t", "shard", "fault"),
    "exchange_retry": ("t", "shard", "attempts", "delivered"),
    "staleness": ("t", "shard", "lag", "quarantined"),
    "repair": ("t", "action", "drift", "cols"),
    "run_aborted": ("error",),
    "run_end": (),
}


def _plain(value: Any) -> Any:
    """Normalize numpy/JAX scalars and small arrays to JSON-native types."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if hasattr(value, "ndim"):            # numpy / JAX array or scalar
        if value.ndim == 0:
            item = value.item()
            return _plain(item)
        return [_plain(v) for v in value.tolist()]
    if hasattr(value, "item"):            # numpy scalar types
        return value.item()
    return value


def make_event(kind: str, run: str, **fields: Any) -> dict:
    """Build (and validate) one event dict with normalized field values."""
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {kind!r}; "
                         f"expected one of {sorted(EVENT_KINDS)}")
    event = {"kind": kind, "run": run}
    for key, value in fields.items():
        event[key] = _plain(value)
    missing = [f for f in EVENT_KINDS[kind] if f not in event]
    if missing:
        raise ValueError(f"event kind {kind!r} missing required "
                         f"fields {missing}")
    return event


def validate_event(event: dict) -> dict:
    """Check an already-built dict (e.g. re-read from JSONL); returns it."""
    kind = event.get("kind")
    if kind not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {kind!r}")
    if "run" not in event:
        raise ValueError("event missing 'run'")
    missing = [f for f in EVENT_KINDS[kind] if f not in event]
    if missing:
        raise ValueError(f"event kind {kind!r} missing required "
                         f"fields {missing}")
    return event
