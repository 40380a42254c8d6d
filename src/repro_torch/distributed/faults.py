"""Deterministic fault injection for the distributed refinement stack
(DESIGN.md §15), PyTorch port of ``repro.distributed.faults``.

A :class:`FaultPlan` is a seeded, host-precomputed schedule of shard
failures, exchange losses/duplications, and aggregate corruption.  Its
arrays stay on the host as numpy arrays: the drivers' Python loops read a
round's ``blocked``, ``repair`` and ``clear`` from them without touching
the device, and upload the masks they apply once per run.  Every
degraded-mode decision the drivers make — which shards are quarantined,
when self-repair fires, how many wire bytes the retries cost — is a pure
function of the plan, derived once in :func:`make_fault_plan`.  That
determinism is what makes the two hard contracts checkable:

* **Bitwise fault-free**: ``fault_plan=None`` dispatches to the
  unmodified drivers; a :func:`zero_fault_plan`
  pushed through the faulty drivers is *also* bitwise identical, because
  degraded election with zero staleness is decision-equivalent to
  :func:`repro_torch.distributed.protocol.elect` and every repair is
  guarded.
* **Recover or raise**: after the run, the carried aggregate state is
  audited against a from-scratch rebuild of the final assignment.  Alive
  shards self-heal to within ``DegradedMode.repair_tol``; a shard still
  down at the end raises :class:`DeadShardError`, and any residual drift
  above the budget raises :class:`RecoveryFailedError` — never a silent
  divergence.

Fault semantics per round ``r`` and shard ``s``:

``down[r, s]``
    The shard is dead this round: it contributes no candidate and misses
    the winner broadcast (its carried block aggregate goes stale).
``omit[r, s]``
    The shard misses this round's winner broadcast only (stale
    aggregate, but its own candidate still competes).
``lost[r, s]``
    Number of failed attempts to deliver the shard's candidate.  Up to
    ``DegradedMode.max_retries`` retries re-send it; beyond that the
    round proceeds without the candidate (bounded timeout, no deadlock).
``dup[r, s]``
    The candidate is delivered twice; the duplicate is dropped by the
    controller but still costs wire bytes.
``corrupt[r, s]`` / ``corrupt_col`` / ``corrupt_val``
    Column ``corrupt_col`` of the shard's carried block aggregate is
    overwritten with ``corrupt_val`` (possibly NaN) at round start.

Staleness follows Adolphs & Berenbrink (arXiv:1109.6925): selfish load
balancing still converges when players act on information up to a
bounded number of rounds old, provided moves clear a threshold that
grows with the staleness.  ``lag[r, s]`` counts missed winner broadcasts
since the last repair; a shard may keep proposing moves while ``lag <=
DegradedMode.max_staleness`` (its acceptance threshold rises by
``stale_penalty`` per stale round), and is quarantined beyond that until
the repair path resynchronizes it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..obs.recorder import _host
from . import protocol

#: bytes per replayed winner record when a repair catches a shard up from
#: bounded staleness: (node i32, dest i32, weight f32) — enough to replay
#: the missed rank-1 aggregate updates against the shard's own row block.
REPLAY_ENTRY_BYTES = 12

#: fixed header charged per full-resync repair (round id) on top of the
#: fresh assignment broadcast (4 bytes per node).
RESYNC_HEADER_BYTES = 4


class FaultToleranceError(RuntimeError):
    """Base class for loud fault-layer failures; carries the report."""

    def __init__(self, message: str, report: "FaultReport | None" = None):
        super().__init__(message)
        self.report = report


class DeadShardError(FaultToleranceError):
    """The run ended while a shard was still down — its block aggregate
    could not be repaired, so the final carried state is untrusted."""


class RecoveryFailedError(FaultToleranceError):
    """Post-run audit found carried state further than the drift budget
    from the recompute oracle even after repair — a fault-layer bug."""


@dataclasses.dataclass(frozen=True)
class DegradedMode:
    """Static degraded-mode protocol parameters (frozen, hashable).

    ``max_retries``
        Bounded retry budget per candidate exchange; a message lost more
        times than this is simply absent from the round (timeout).
    ``max_staleness``
        Bounded-staleness window S: a shard whose aggregate is up to S
        winner broadcasts old keeps participating; beyond S it is
        quarantined until repaired (1109.6925 licenses the window, not
        unbounded staleness).
    ``stale_penalty``
        Acceptance-threshold increment per stale round: a shard with lag
        L only proposes moves with gain > tol + L*stale_penalty, the
        S-dependent threshold from the bounded-staleness analysis.
    ``repair_every``
        Periodic repair cadence (rounds); repair also fires immediately
        when a shard's lag exceeds ``max_staleness`` and at the horizon.
    ``repair_tol``
        Per-column absolute deviation above which a repair replaces the
        carried column with the recompute oracle's (NaN always fails).
    """

    max_retries: int = 2
    max_staleness: int = 4
    stale_penalty: float = 0.05
    repair_every: int = 16
    repair_tol: float = 1e-3


DEFAULT_DEGRADED = DegradedMode()


class FaultPlan(NamedTuple):
    """Seeded fault schedule + host-derived degraded-mode consequences.

    All per-shard arrays have shape ``(R + 1, num_shards)`` where ``R``
    is the requested horizon; the final row is all-clear so drivers can
    index ``min(round, R)`` and runs that outlive the fault horizon see
    a healthy cluster.  ``clear`` has shape ``(R + 1,)``.

    Raw schedule: ``down``, ``omit``, ``lost``, ``dup``, ``corrupt``,
    ``corrupt_col``, ``corrupt_val``.  Derived (pure functions of the
    raw schedule + :class:`DegradedMode`, precomputed so the wire ledger
    and the traced drivers agree byte-exactly): ``delivered`` (candidate
    arrives within the retry budget), ``retries`` (paid re-sends),
    ``lag`` (staleness at round start), ``quarantined`` (lag exceeded
    the bounded-staleness window), ``repair`` (self-repair fires at this
    round's end), ``repair_bytes`` (wire cost of that repair), and
    ``clear`` (no fault effect is active anywhere — idle/convergence
    counting is only allowed on clear rounds).
    """

    down: np.ndarray          # (R+1, S) bool
    omit: np.ndarray          # (R+1, S) bool
    lost: np.ndarray          # (R+1, S) int32
    dup: np.ndarray           # (R+1, S) bool
    corrupt: np.ndarray       # (R+1, S) bool
    corrupt_col: np.ndarray   # (R+1, S) int32
    corrupt_val: np.ndarray   # (R+1, S) float32
    delivered: np.ndarray     # (R+1, S) bool
    retries: np.ndarray       # (R+1, S) int32
    lag: np.ndarray           # (R+1, S) int32
    quarantined: np.ndarray   # (R+1, S) bool
    repair: np.ndarray        # (R+1, S) bool
    repair_bytes: np.ndarray  # (R+1, S) int32
    clear: np.ndarray         # (R+1,) bool

    @property
    def horizon(self) -> int:
        """Last (all-clear) row index == the requested num_rounds."""
        return self.down.shape[0] - 1

    @property
    def num_shards(self) -> int:
        return self.down.shape[1]


class FaultOutcome(NamedTuple):
    """Device-side scalars the faulty drivers return for the audit."""

    final_drift: torch.Tensor       # f32: pre-repair max |carried - oracle|
    post_drift: torch.Tensor        # f32: residual after the final repair
    dead: torch.Tensor | bool       # some shard down at the last round
    repairs: torch.Tensor           # int32: in-loop repair rounds executed
    repaired_cols: torch.Tensor     # int32: columns replaced (in-loop+final)
    max_repair_drift: torch.Tensor  # f32: worst pre-repair drift seen


class FaultReport(NamedTuple):
    """Host-side recovery verdict built by :func:`build_report`."""

    recovered: bool
    dead: bool                 # some shard was still down at run end
    recovery_drift: float      # residual carried-vs-oracle drift
    pre_repair_drift: float    # worst drift before the final repair
    max_repair_drift: float    # worst drift any in-loop repair healed
    repairs: int
    repaired_cols: int
    retries: int
    dups: int
    down_rounds: int
    stale_rounds: int
    quarantined_rounds: int
    recovery_round: int | None  # first clear round after the last fault
    rounds: int


def _derive(down: np.ndarray, omit: np.ndarray, lost: np.ndarray,
            dup: np.ndarray, corrupt: np.ndarray, degraded: DegradedMode,
            num_nodes: int) -> dict[str, np.ndarray]:
    """Roll the degraded-mode state machine forward on the host.

    The drivers never decide *when* staleness accrues or repair fires —
    they read it from these arrays — so lag must not depend on anything
    data-dependent (like whether a round's winner actually moved).  A
    missed broadcast counts as one stale round regardless; that makes
    the schedule, and therefore the retry/repair wire ledger, exact.
    """
    rounds, shards = down.shape
    delivered = ~down & (lost <= degraded.max_retries)
    retries = np.minimum(lost, degraded.max_retries).astype(np.int32)
    lag = np.zeros((rounds, shards), np.int32)
    quarantined = np.zeros((rounds, shards), bool)
    repair = np.zeros((rounds, shards), bool)
    repair_bytes = np.zeros((rounds, shards), np.int32)
    tainted = np.zeros((rounds, shards), bool)
    pending_corrupt = np.zeros(shards, bool)
    cur_lag = np.zeros(shards, np.int32)
    for r in range(rounds):
        lag[r] = cur_lag
        quarantined[r] = cur_lag > degraded.max_staleness
        tainted[r] = pending_corrupt | corrupt[r]
        lag_end = cur_lag + (down[r] | omit[r]).astype(np.int32)
        pend = pending_corrupt | corrupt[r]
        want = (lag_end > 0) | pend
        boundary = (((r + 1) % degraded.repair_every == 0)
                    | (lag_end > degraded.max_staleness)
                    | (r == rounds - 1))
        fires = want & boundary & ~down[r]
        repair[r] = fires
        full = lag_end > degraded.max_staleness
        repair_bytes[r] = np.where(
            fires,
            np.where(full, 4 * num_nodes + RESYNC_HEADER_BYTES,
                     REPLAY_ENTRY_BYTES * lag_end),
            0).astype(np.int32)
        cur_lag = np.where(fires, 0, lag_end).astype(np.int32)
        pending_corrupt = pend & ~fires
    clear = (delivered & ~down & ~quarantined & (lag == 0)
             & ~tainted).all(axis=1)
    return dict(delivered=delivered, retries=retries, lag=lag,
                quarantined=quarantined, repair=repair,
                repair_bytes=repair_bytes, clear=clear)


def _assemble(down, omit, lost, dup, corrupt, corrupt_col, corrupt_val,
              degraded: DegradedMode, num_nodes: int) -> FaultPlan:
    """Derive consequences, append the all-clear horizon row."""
    derived = _derive(down, omit, lost, dup, corrupt, degraded, num_nodes)
    shards = down.shape[1]

    def pad(a, fill):
        tail = np.full((1,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, tail], axis=0)

    return FaultPlan(
        down=np.asarray(pad(down, False)),
        omit=np.asarray(pad(omit, False)),
        lost=np.asarray(pad(lost.astype(np.int32), 0)),
        dup=np.asarray(pad(dup, False)),
        corrupt=np.asarray(pad(corrupt, False)),
        corrupt_col=np.asarray(pad(corrupt_col.astype(np.int32), 0)),
        corrupt_val=np.asarray(pad(corrupt_val.astype(np.float32), 0.0)),
        delivered=np.asarray(pad(derived["delivered"], True)),
        retries=np.asarray(pad(derived["retries"], 0)),
        lag=np.asarray(pad(derived["lag"], 0)),
        quarantined=np.asarray(pad(derived["quarantined"], False)),
        repair=np.asarray(pad(derived["repair"], False)),
        repair_bytes=np.asarray(pad(derived["repair_bytes"], 0)),
        clear=np.asarray(np.concatenate(
            [derived["clear"], np.ones(1, bool)])),
        )


def make_fault_plan(num_rounds: int, num_shards: int, seed: int = 0, *,
                    degraded: DegradedMode | None = None,
                    p_down: float = 0.0,
                    down_length: tuple[int, int] = (2, 5),
                    p_omit: float = 0.0,
                    p_lost: float = 0.0, max_lost: int = 3,
                    p_dup: float = 0.0,
                    p_corrupt: float = 0.0, corrupt_scale: float = 100.0,
                    nan_frac: float = 0.25,
                    num_machines: int = 1,
                    num_nodes: int = 0) -> FaultPlan:
    """Draw a seeded fault schedule and derive its degraded-mode arrays.

    ``p_down`` starts a contiguous outage of ``down_length`` rounds per
    eligible round; the other probabilities are per (round, shard).
    ``num_machines`` bounds ``corrupt_col``; ``num_nodes`` prices the
    full-resync repair of a long outage in the wire ledger.
    """
    dm = degraded or DEFAULT_DEGRADED
    rng = np.random.default_rng(seed)
    rounds, shards = int(num_rounds), int(num_shards)
    down = np.zeros((rounds, shards), bool)
    for s in range(shards):
        r = 0
        while r < rounds:
            if rng.random() < p_down:
                length = int(rng.integers(down_length[0],
                                          down_length[1] + 1))
                down[r:r + length, s] = True
                r += length
            else:
                r += 1
    omit = (rng.random((rounds, shards)) < p_omit) & ~down
    lost = np.where(rng.random((rounds, shards)) < p_lost,
                    rng.integers(1, max_lost + 1, (rounds, shards)),
                    0).astype(np.int32)
    lost = np.where(down, 0, lost)  # a down shard sends nothing at all
    dup = (rng.random((rounds, shards)) < p_dup) & ~down
    corrupt = rng.random((rounds, shards)) < p_corrupt
    corrupt_col = rng.integers(0, max(1, num_machines), (rounds, shards))
    corrupt_val = rng.uniform(-corrupt_scale, corrupt_scale,
                              (rounds, shards)).astype(np.float32)
    corrupt_val = np.where(rng.random((rounds, shards)) < nan_frac,
                           np.float32(np.nan), corrupt_val)
    return _assemble(down, omit, lost, dup, corrupt, corrupt_col,
                     corrupt_val, dm, num_nodes)


def zero_fault_plan(num_rounds: int, num_shards: int,
                    degraded: DegradedMode | None = None) -> FaultPlan:
    """An all-clear plan: pushing it through the faulty drivers must be
    bitwise identical to ``fault_plan=None`` (pinned by tests)."""
    return make_fault_plan(num_rounds, num_shards, seed=0,
                           degraded=degraded)


def plan_row(plan: FaultPlan, t: int) -> FaultPlan:
    """Index round ``t`` (clamped to the all-clear horizon row)."""
    idx = min(int(t), plan.horizon)
    return FaultPlan(*(a[idx] for a in plan))


def device_plan(plan: FaultPlan, device) -> FaultPlan:
    """The plan's arrays as tensors on ``device``, uploaded once per run,
    for the masks the drivers apply on the device."""
    return FaultPlan(*(torch.as_tensor(a, device=device) for a in plan))


def message_bytes(*, traced: bool, simultaneous: bool,
                  num_machines: int) -> int:
    """Size of one shard's candidate message for retry/dup accounting.

    Sequential exchanges carry one Candidate (plus the 8-byte potential
    deltas on the traced path — faulty drivers are incremental-only);
    sweep exchanges carry the shard's K-candidate block.  Retries only
    re-send the candidate payload, not the per-round partial reductions.
    """
    if simultaneous:
        return num_machines * protocol.CANDIDATE_BYTES
    return protocol.CANDIDATE_BYTES + (
        protocol.TRACE_PARTIAL_BYTES if traced else 0)


def round_extra_bytes(row: FaultPlan, per_message_bytes: int) -> int:
    """Extra wire for one executed round: re-sends + repair traffic.

    The drivers add this up round by round under ``measure_wire`` so the
    measured payload includes fault traffic; :func:`plan_extra_bytes`
    computes the same total from the plan alone for the ledger, and
    ``accounting.reconcile`` demands they agree byte-exactly.
    """
    resend = (row.retries + row.dup.astype(np.int32)) * per_message_bytes
    return int(np.sum(resend + row.repair_bytes))


def plan_extra_bytes(plan: FaultPlan, rounds: int,
                     per_message_bytes: int) -> int:
    """Host-side total fault wire bytes over the executed rounds."""
    idx = np.minimum(np.arange(int(rounds)), plan.horizon)
    retries = np.asarray(plan.retries)[idx]
    dups = np.asarray(plan.dup)[idx].astype(np.int64)
    repair = np.asarray(plan.repair_bytes)[idx]
    return int(((retries + dups) * per_message_bytes + repair).sum())


def build_report(plan: FaultPlan, outcome: FaultOutcome, rounds: int, *,
                 budget: float = 1e-3,
                 raise_on_failure: bool = True) -> FaultReport:
    """Turn the device audit + plan into the recovery verdict.

    Raises :class:`DeadShardError` if the run ended inside an outage and
    :class:`RecoveryFailedError` if residual drift exceeds the budget —
    the "fails loudly, never silently diverges" half of the contract.
    """
    rounds = int(rounds)
    idx = np.minimum(np.arange(rounds), plan.horizon)
    down = np.asarray(plan.down)[idx]
    lag = np.asarray(plan.lag)[idx]
    quarantined = np.asarray(plan.quarantined)[idx]
    clear = np.asarray(plan.clear)[idx]
    unclear = np.nonzero(~clear)[0]
    recovery_round = None
    if unclear.size:
        last = int(unclear[-1])
        recovery_round = last + 1 if last + 1 < rounds else None
    dead = bool(outcome.dead)
    post = float(outcome.post_drift)
    report = FaultReport(
        recovered=not dead and post <= budget,
        dead=dead,
        recovery_drift=post,
        pre_repair_drift=float(outcome.final_drift),
        max_repair_drift=float(outcome.max_repair_drift),
        repairs=int(outcome.repairs),
        repaired_cols=int(outcome.repaired_cols),
        retries=int(np.asarray(plan.retries)[idx].sum()),
        dups=int(np.asarray(plan.dup)[idx].sum()),
        down_rounds=int(down.any(axis=1).sum()),
        stale_rounds=int((lag > 0).any(axis=1).sum()),
        quarantined_rounds=int(quarantined.any(axis=1).sum()),
        recovery_round=recovery_round,
        rounds=rounds,
        )
    if raise_on_failure:
        raise_if_failed(report, budget=budget)
    return report


def raise_if_failed(report: FaultReport, *,
                    budget: float = 1e-3) -> FaultReport:
    """The loud half of the recover-or-raise contract."""
    if report.dead:
        raise DeadShardError(
            f"run ended after {report.rounds} rounds with a shard still "
            f"down; carried drift {report.pre_repair_drift:g} cannot be "
            "repaired", report)
    if not report.recovered:
        raise RecoveryFailedError(
            f"residual carried-state drift {report.recovery_drift:g} "
            f"exceeds the {budget:g} recovery budget after repair", report)
    return report


def emit_fault_events(recorder, run: str, plan: FaultPlan, rounds: int,
                      repair_drift=None, repaired_cols=None,
                      repaired=None) -> None:
    """Replay the plan's executed rounds into fault telemetry events.

    ``repair_drift``/``repaired_cols``/``repaired`` are the per-round
    side outputs of the traced faulty driver when available (tensors on
    any device, or arrays); without them repair events carry the plan's
    schedule only.
    """
    rounds = int(rounds)
    idx = np.minimum(np.arange(rounds), plan.horizon)
    down = np.asarray(plan.down)[idx]
    omit = np.asarray(plan.omit)[idx]
    lost = np.asarray(plan.lost)[idx]
    dup = np.asarray(plan.dup)[idx]
    corrupt = np.asarray(plan.corrupt)[idx]
    delivered = np.asarray(plan.delivered)[idx]
    retries = np.asarray(plan.retries)[idx]
    lag = np.asarray(plan.lag)[idx]
    quarantined = np.asarray(plan.quarantined)[idx]
    repair = np.asarray(plan.repair)[idx]
    drift = _host(repair_drift) if repair_drift is not None else None
    cols = _host(repaired_cols) if repaired_cols is not None else None
    did = _host(repaired) if repaired is not None else None
    for t in range(rounds):
        for s in range(plan.num_shards):
            for name, hit in (("down", down[t, s]),
                              ("omit", omit[t, s]),
                              ("dup", dup[t, s]),
                              ("corrupt", corrupt[t, s])):
                if hit:
                    recorder.emit("fault_injected", run, t=t, shard=s,
                                  fault=name)
            if lost[t, s]:
                recorder.emit("exchange_retry", run, t=t, shard=s,
                              attempts=int(retries[t, s]),
                              delivered=bool(delivered[t, s]))
            if lag[t, s] or quarantined[t, s]:
                recorder.emit("staleness", run, t=t, shard=s,
                              lag=int(lag[t, s]),
                              quarantined=bool(quarantined[t, s]))
        if repair[t].any() and (did is None or did[t]):
            recorder.emit(
                "repair", run, t=t, action="column",
                drift=float(drift[t]) if drift is not None else None,
                cols=int(cols[t]) if cols is not None else None)
