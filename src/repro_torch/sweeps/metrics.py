"""Reduction helpers for sweep results (DESIGN.md §12.5).

Host-side (numpy) post-processing of batched runs: the sweep runtime
returns per-element device arrays; these helpers reduce them to the
statistics the paper's claims are about (cross-machine load CV, CV
descent traces, time-averaged DES backlog CV).
"""
from __future__ import annotations

import numpy as np


def load_cv(loads, speeds) -> np.ndarray:
    """Cross-machine coefficient of variation of the weighted loads
    ``L_k / w_k`` (the Eq.-8 balance quantity) over the last axis.

    Accepts ``(K,)`` or ``(..., K)``; returns a scalar / ``(...,)`` array.
    0 means perfectly balanced for the machines' speeds.
    """
    weighted = np.asarray(loads, np.float64) / np.asarray(speeds, np.float64)
    mean = weighted.mean(axis=-1)
    std = weighted.std(axis=-1)
    return std / np.maximum(mean, 1e-12)


def load_cv_trace(node_weights, speeds, assignment0, trace) -> np.ndarray:
    """(T,) weighted-load CV after every turn of a ``Trace``.

    Replays the move sequence on host: starting from ``assignment0``'s
    machine loads, each ``moved`` turn shifts ``b[node]`` from ``source``
    to ``dest``.  O(T + N) numpy — no device work, usable on any number
    of sweep elements.  Turns after convergence repeat the final value
    (the trace's no-op turns).
    """
    b = np.asarray(node_weights, np.float64)
    w = np.asarray(speeds, np.float64)
    r0 = np.asarray(assignment0)
    k = w.shape[0]
    loads = np.zeros(k)
    np.add.at(loads, r0, b)
    moved = np.asarray(trace.moved)
    node = np.asarray(trace.node)
    src = np.asarray(trace.source)
    dst = np.asarray(trace.dest)
    out = np.empty(moved.shape[0])
    for t in range(moved.shape[0]):
        if moved[t]:
            loads[src[t]] -= b[node[t]]
            loads[dst[t]] += b[node[t]]
        out[t] = load_cv(loads, w)
    return out


def time_averaged_cv(trace: np.ndarray) -> float:
    """Time-averaged cross-machine CV of a ``(T, K)`` DES load trace
    (e.g. ``DESState.trace_wload`` rows up to ``trace_ptr``), counting
    only active ticks (rows with nonzero mean) — the summary statistic
    of ``benchmarks/dynamics_bench.py``.
    """
    trace = np.asarray(trace, np.float64)
    if trace.size == 0:
        return 0.0
    mean = trace.mean(axis=1)
    active = mean > 1e-6
    if not active.any():
        return 0.0
    std = trace[active].std(axis=1)
    return float(np.mean(std / np.maximum(mean[active], 1e-6)))
