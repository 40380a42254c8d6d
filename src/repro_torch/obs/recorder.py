"""The Recorder: event buffering, phase timing, device-row draining
(DESIGN.md §14.2–§14.3), PyTorch port of ``repro.obs.recorder``.

The Recorder is the single object an instrumented entry point needs: it
assigns run ids, buffers every event in ``self.events`` (the canonical
in-process stream), fans events out to attached sinks, times wall-clock
phases, and bridges device→host telemetry.

Host-side only: this module imports numpy and the standard library.
All potentially-hot device work stays in the instrumented modules; what
crosses here is either post-run arrays (trace ingestion) or rows read
back from the device once a run has ended.  Every array a run hands over
goes through :func:`_host`, which copies a tensor (on the card or not)
to a numpy array — ``np.asarray`` alone raises on a CUDA tensor — and
takes anything else as ``np.asarray`` does.

Device-row bridge
-----------------
The port's loops are host loops over device tensors that read the card
only every few dozen turns or ticks.  With telemetry enabled, each turn
(``repro_torch.core.refine.refine``) or each ``trace_stride``-th DES tick
appends its raw row to a buffer on the device
(:mod:`repro_torch.obs.rows`); the entry point reads the rows back once,
after the run, and feeds them to :meth:`Recorder._on_turn_row`,
:meth:`_on_tick_row` and :meth:`_on_refine_row` — the names of the
reference's callback targets, which still only buffer raw scalars — and
drains the buffers (sorted by turn or tick index) into events.

Hashing: a Recorder is hashable *by identity* (no ``__eq__``).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterable, Sequence

import numpy as np

from .events import make_event

# Standing accuracy budget for carried quantities (ROADMAP contract).
DRIFT_BUDGET = 1e-3


def _host(x) -> np.ndarray:
    """A host numpy copy of ``x``: a tensor's values (from any device),
    or ``np.asarray(x)`` for anything else."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Recorder:
    """Buffers typed telemetry events and fans them out to sinks."""

    def __init__(self, sinks: Sequence = (), tol: float = 1e-6):
        self.sinks = list(sinks)
        self.events: list[dict] = []
        self.tol = float(tol)
        self._next_run = 0
        self._last_run: str | None = None
        self._rows: list[tuple] = []
        self._tick_rows: list[tuple] = []
        self._refine_rows: list[tuple] = []

    # ------------------------------------------------------------------
    # core emission
    # ------------------------------------------------------------------
    def new_run(self, runtime: str, **meta) -> str:
        """Open a run; returns its id (``r0000``, ``r0001``, ...)."""
        run = f"r{self._next_run:04d}"
        self._next_run += 1
        self._last_run = run
        self.emit("run_start", run, runtime=runtime, **meta)
        return run

    def emit(self, kind: str, run: str, **fields) -> dict:
        event = make_event(kind, run, **fields)
        self.events.append(event)
        for sink in self.sinks:
            sink.write(event)
        return event

    def flush(self) -> None:
        for sink in self.sinks:
            sink.flush()

    def close(self) -> None:
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()

    @contextmanager
    def phase(self, name: str, run: str | None = None):
        """Wall-clock a span; emits one ``phase`` event on exit.

        If the wrapped block raises (e.g. a jit failure before
        ``block_until_ready``), the span is still closed, a terminal
        ``run_aborted`` event records the error, and the sinks are
        flushed — everything buffered up to the abort survives on disk
        instead of being lost with the process (DESIGN.md §15.6)."""
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as exc:
            rid = run or self._last_run or "r----"
            self.emit("phase", rid, name=name, ts=t0,
                      dur=time.perf_counter() - t0)
            self.emit("run_aborted", rid, error=repr(exc),
                      pending_rows=len(self._rows) + len(self._tick_rows)
                      + len(self._refine_rows))
            self.flush()
            raise
        else:
            self.emit("phase", run or self._last_run or "r----",
                      name=name, ts=t0, dur=time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # device-row bridge (rows read back after the run)
    # ------------------------------------------------------------------
    def _on_turn_row(self, *cols) -> None:
        """Per-turn row target: buffer raw scalars, nothing else."""
        self._rows.append(tuple(_host(c) for c in cols))

    def _on_tick_row(self, *cols) -> None:
        """Per-DES-tick row target (trace_stride cadence)."""
        self._tick_rows.append(tuple(_host(c) for c in cols))

    def _on_refine_row(self, *cols) -> None:
        """Per-DES-refinement-round row target."""
        self._refine_rows.append(tuple(_host(c) for c in cols))

    def begin_rows(self) -> None:
        self._rows = []
        self._tick_rows = []
        self._refine_rows = []

    def take_rows(self) -> list[tuple]:
        rows, self._rows = self._rows, []
        return rows

    def record_des_rows(self, run: str) -> int:
        """Emit ``tick`` + ``des_refine`` events from the drained DES
        row buffers (sorted by tick).

        Tick rows are ``(t, gvt, processed, rollbacks, refines, moves,
        mean_len, wload_cv, segment, frozen)``; refine rows are
        ``(t, moves, frozen)`` — one per executed refinement round.
        """
        tick_rows, self._tick_rows = self._tick_rows, []
        refine_rows, self._refine_rows = self._refine_rows, []
        for (t, gvt, processed, rollbacks, refines, moves, mean_len,
             wload_cv, segment, frozen) in sorted(
                 tick_rows, key=lambda r: int(r[0])):
            self.emit("tick", run, t=int(t), gvt=float(gvt),
                      processed=int(processed), rollbacks=int(rollbacks),
                      refines=int(refines), moves=int(moves),
                      mean_len=float(mean_len), wload_cv=float(wload_cv),
                      segment=int(segment), frozen=int(frozen))
        for (t, moves, frozen) in sorted(refine_rows,
                                         key=lambda r: int(r[0])):
            self.emit("des_refine", run, t=int(t), moves=int(moves),
                      frozen=int(frozen))
        return len(tick_rows) + len(refine_rows)

    def record_turn_rows(self, run: str, rows: Iterable[tuple],
                         node_weights, *, carried: bool = True,
                         batch=None) -> int:
        """Emit ``turn`` events from drained device rows.

        Each row is ``(t, machine, moved, node, source, dest, gain, c0,
        ct0, raw_gain)`` as produced by the instrumented while-loop body.
        Rows are sorted by turn index before emission.
        """
        b = _host(node_weights)
        rows = sorted(rows, key=lambda r: int(r[0]))
        for (t, machine, moved, node, source, dest, gain, c0, ct0,
             raw_gain) in rows:
            self._emit_turn(run, int(t), int(machine), bool(moved),
                            int(node), int(source), int(dest), float(gain),
                            float(c0) if carried else None,
                            float(ct0) if carried else None,
                            float(raw_gain), b, batch)
        return len(rows)

    # ------------------------------------------------------------------
    # post-run trace ingestion (scan entry points, distributed drivers)
    # ------------------------------------------------------------------
    def record_trace(self, run: str, trace, node_weights, num_machines: int,
                     *, raw_gain=None, carried: bool = True,
                     batch=None) -> int:
        """Emit ``turn`` events from a ``refine_traced``-shape ``Trace``.

        Works on any object with ``moved/node/source/dest/gain/c0/ct0/
        active`` arrays (the core and distributed traced drivers share
        the shape).  Only active turns are emitted; the sequential
        round-robin convention fixes the acting machine as ``t % K``.
        ``raw_gain`` (the θ-free best gain, from the telemetry side
        output) enables hysteresis-vs-satisfied rejection labels.
        """
        b = _host(node_weights)
        active = _host(trace.active)
        moved = _host(trace.moved)
        node = _host(trace.node)
        source = _host(trace.source)
        dest = _host(trace.dest)
        gain = _host(trace.gain)
        c0 = _host(trace.c0)
        ct0 = _host(trace.ct0)
        raw = None if raw_gain is None else _host(raw_gain)
        count = 0
        for t in range(moved.shape[0]):
            if not active[t]:
                continue
            self._emit_turn(run, t, t % int(num_machines), bool(moved[t]),
                            int(node[t]), int(source[t]), int(dest[t]),
                            float(gain[t]),
                            float(c0[t]) if carried else None,
                            float(ct0[t]) if carried else None,
                            None if raw is None else float(raw[t]),
                            b, batch)
            count += 1
        return count

    def _emit_turn(self, run, t, machine, moved, node, source, dest, gain,
                   c0, ct0, raw_gain, b, batch) -> None:
        if moved:
            reject = None
        elif raw_gain is None:
            reject = "unknown"
        else:
            reject = "hysteresis" if raw_gain > self.tol else "satisfied"
        fields = dict(t=t, machine=machine, moved=moved,
                      node=node if moved else None,
                      source=source if moved else None,
                      dest=dest if moved else None,
                      gain=gain if moved else None,
                      weight=float(b[node]) if moved else None,
                      c0=c0, ct0=ct0, reject=reject)
        if raw_gain is not None and np.isfinite(raw_gain):
            fields["raw_gain"] = float(raw_gain)
        if batch is not None:
            fields["batch"] = int(batch)
        self.emit("turn", run, **fields)

    def record_sweeps(self, run: str, c0s, ct0s, active, movers=None,
                      batch=None) -> int:
        """Emit ``sweep`` events from simultaneous-mode per-sweep outputs."""
        c0s = _host(c0s)
        ct0s = _host(ct0s)
        act = _host(active)
        mv = None if movers is None else _host(movers)
        count = 0
        for t in range(act.shape[0]):
            if not act[t]:
                continue
            fields = dict(t=t, movers=-1 if mv is None else int(mv[t]),
                          c0=float(c0s[t]), ct0=float(ct0s[t]),
                          active=bool(act[t]))
            if batch is not None:
                fields["batch"] = int(batch)
            self.emit("sweep", run, **fields)
            count += 1
        return count

    # ------------------------------------------------------------------
    # run closure, drift, wire reconciliation
    # ------------------------------------------------------------------
    def record_result(self, run: str, result, *, wall: float | None = None,
                      c0=None, ct0=None,
                      drift_budget: float = DRIFT_BUDGET, **extra) -> None:
        """Emit the ``drift`` check and the closing ``run_end`` event.

        ``result`` is any ``RefineResult``-shaped object (duck-typed:
        ``num_moves/num_turns/converged/loads/aggregate_drift``).
        ``extra`` fields ride on the ``run_end`` verbatim — fault-
        injected runs attach ``recovered``/``recovery_drift``
        (DESIGN.md §15.6)."""
        drift = float(_host(result.aggregate_drift))
        self.emit("drift", run, value=drift, budget=drift_budget,
                  ok=drift <= drift_budget)
        fields = dict(num_moves=int(_host(result.num_moves)),
                      num_turns=int(_host(result.num_turns)),
                      converged=bool(_host(result.converged)),
                      loads=_host(result.loads),
                      aggregate_drift=drift)
        if wall is not None:
            fields["wall"] = float(wall)
        if c0 is not None:
            fields["c0"] = float(c0)
        if ct0 is not None:
            fields["ct0"] = float(ct0)
        fields.update(extra)
        self.emit("run_end", run, **fields)

    def record_wire(self, run: str, check) -> None:
        """Emit a ``wire`` event from an ``accounting.WireCheck``."""
        self.emit("wire", run, rounds=int(check.rounds),
                  measured_payload=int(check.measured_payload),
                  predicted_payload=int(check.predicted_payload),
                  measured_setup=int(check.measured_setup),
                  predicted_setup=int(check.predicted_setup),
                  ok=bool(check.ok))

    # ------------------------------------------------------------------
    # convenience views
    # ------------------------------------------------------------------
    def events_for(self, run: str) -> list[dict]:
        return [e for e in self.events if e["run"] == run]
