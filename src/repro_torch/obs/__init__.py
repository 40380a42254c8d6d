"""Run telemetry layer (DESIGN.md §14), PyTorch port of ``repro.obs``.

Structured, typed event streams from every execution axis of the port —
the four ``repro_torch.core.refine`` entry points, the DES engine ticks
and refinement rounds, the ``repro_torch.distributed`` drivers (with
*measured* wire-byte counters reconciled against the analytic ledger, and
fault events), and the batched sweep runtime — plus sinks (JSONL run
logs, Chrome-trace/Perfetto phase timing) and a replay/report CLI
(``python -m repro_torch.obs.report``).  The event schema and log format
are the reference's, so either package's report CLI reads the other's
logs.

Telemetry is strictly opt-in: every instrumented entry point takes
``recorder=None`` and the ``None`` path is the exact pre-telemetry
computation — the same torch operations, the same kernel launches and
host reads, bitwise-identical results (``tests/test_torch_obs.py`` pins
the operations).  With a recorder, per-turn and per-tick rows are
written to buffers on the device (:mod:`repro_torch.obs.rows`) and read
back once a run ends.
"""
from .events import EVENT_KINDS, make_event, validate_event
from .recorder import Recorder
from .sinks import JsonlSink, MemorySink, chrome_trace, read_jsonl

__all__ = [
    "EVENT_KINDS",
    "JsonlSink",
    "MemorySink",
    "Recorder",
    "chrome_trace",
    "make_event",
    "read_jsonl",
    "validate_event",
]
