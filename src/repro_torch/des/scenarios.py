"""Machine-churn scenarios: piecewise-constant per-machine speed schedules,
PyTorch port of ``repro.des.scenarios``.

The paper's cost frameworks carry per-machine speeds ``w_k`` (Eq. 1/6)
precisely because real clusters are not uniform AND not static: machines
slow down (co-tenancy, thermal throttling), fail, and recover while the
workload's hot spots move.  A :class:`SpeedSchedule` is the minimal model
of that churn — a sorted list of wall-clock tick boundaries and, per
segment, the (K,) relative machine speeds in effect (1.0 = nominal; see
DESIGN.md §11).  :mod:`repro_torch.des.engine` consumes it per tick:
busy-time scales inversely with the resident machine's current speed, and
each refinement round feeds the live speeds into the partition game.

Builders are host-side (numpy draws, the reference's exactly); a schedule
is a pair of CPU tensors, pure data like a workload, which the engine
carries to the simulation's device once per run.

Speeds are clamped to ``MIN_SPEED`` by default — a "failed" machine is
modeled as nearly-stopped rather than stopped.  Passing ``floor=0.0``
(or using :func:`true_failure`) lifts the clamp: speed ``0`` is the
engine's "machine down" state (DESIGN.md §15.5) — the machine's LPs are
quarantined (queues frozen, no busy-time countdown) until the schedule
restores a positive speed, and the refinement layer re-homes LPs off the
dead machine via the existing game.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MIN_SPEED = 0.02   # floor for "failed" machines (busy-time divides by speed)


class SpeedSchedule(NamedTuple):
    """Piecewise-constant machine speeds over wall-clock ticks.

    Segment ``s`` is in effect for ticks in ``[times[s], times[s+1])``
    (the last segment extends forever).  ``times[0]`` must be 0 so every
    tick is covered.  A stacked schedule (:func:`stack_schedules`) has
    (B, S) times and (B, S, K) speeds.
    """
    times: torch.Tensor    # (S,) int32 — ascending segment-start ticks
    speeds: torch.Tensor   # (S, K) float32 — relative speeds, 1.0 = nominal

    @property
    def num_machines(self) -> int:
        return self.speeds.shape[-1]

    def to(self, device) -> "SpeedSchedule":
        return SpeedSchedule(self.times.to(device), self.speeds.to(device))


def make_schedule(times, speeds, *, floor: float = MIN_SPEED
                  ) -> SpeedSchedule:
    """Validate + clamp host-side arrays into a :class:`SpeedSchedule`.

    ``floor`` is the speed clamp; the ``MIN_SPEED`` default keeps the
    pre-fault-model "failure = nearly stopped" semantics.  ``floor=0.0``
    permits exact-zero segments — the engine's "machine down" state
    (:func:`true_failure`); negative inputs clamp to the floor either
    way."""
    times = np.asarray(times, np.int32)
    speeds = np.asarray(speeds, np.float32)
    if times.ndim != 1 or speeds.ndim != 2 or times.shape[0] != speeds.shape[0]:
        raise ValueError(f"shape mismatch: times {times.shape} vs "
                         f"speeds {speeds.shape}")
    if times.shape[0] == 0 or times[0] != 0:
        raise ValueError("times must start at tick 0")
    if np.any(np.diff(times) <= 0):
        raise ValueError("times must be strictly ascending")
    speeds = np.maximum(speeds, np.float32(floor))
    return SpeedSchedule(times=torch.as_tensor(times),
                         speeds=torch.as_tensor(speeds))


def segment_at(schedule: SpeedSchedule, tick) -> torch.Tensor:
    """Index of the segment in effect at wall-clock ``tick``: () for one
    schedule and a () tick, (B,) for a stacked schedule and (B,) ticks."""
    tick = torch.as_tensor(tick, device=schedule.times.device)
    idx = torch.sum((schedule.times <= tick[..., None]).to(torch.int32),
                    dim=-1) - 1
    return torch.clamp(idx, 0, schedule.times.shape[-1] - 1)


def speeds_at(schedule: SpeedSchedule, tick) -> torch.Tensor:
    """Speeds in effect at wall-clock ``tick``: (K,), or (B, K) for a
    stacked schedule and (B,) ticks."""
    seg = segment_at(schedule, tick).long()
    k = schedule.speeds.shape[-1]
    index = seg[..., None, None].expand(*seg.shape, 1, k)
    return schedule.speeds.gather(-2, index)[..., 0, :]


# ---------------------------------------------------------------------------
# scenario builders (host-side)
# ---------------------------------------------------------------------------

def constant(num_machines: int, speeds=None) -> SpeedSchedule:
    """One segment: fixed (possibly heterogeneous) speeds forever."""
    row = np.ones(num_machines, np.float32) if speeds is None \
        else np.asarray(speeds, np.float32)
    return make_schedule([0], row[None, :])


def slowdown(num_machines: int, machine: int, at_tick: int,
             factor: float = 0.25, recover_tick: int | None = None,
             base=None) -> SpeedSchedule:
    """``machine`` drops to ``factor`` of its base speed at ``at_tick``
    (co-tenant / throttling churn), optionally recovering later."""
    base = np.ones(num_machines, np.float32) if base is None \
        else np.asarray(base, np.float32)
    rows, times = [base], [0]
    slow = base.copy()
    slow[machine] = base[machine] * factor
    rows.append(slow)
    times.append(at_tick)
    if recover_tick is not None:
        rows.append(base)
        times.append(recover_tick)
    return make_schedule(times, np.stack(rows))


def failure_recovery(num_machines: int, machine: int, fail_tick: int,
                     recover_tick: int, floor: float = MIN_SPEED,
                     base=None) -> SpeedSchedule:
    """``machine`` all-but-stops at ``fail_tick`` and comes back at
    ``recover_tick`` — the scenario that forces LP re-homing and then
    tests whether the partitioner thrashes everything straight back."""
    return slowdown(num_machines, machine, fail_tick,
                    factor=floor, recover_tick=recover_tick, base=base)


def true_failure(num_machines: int, machine: int, fail_tick: int,
                 recover_tick: int | None = None, base=None) -> SpeedSchedule:
    """``machine`` is DOWN (speed exactly 0) from ``fail_tick`` until
    ``recover_tick`` (forever if ``None``) — the DESIGN.md §15.5 fault
    scenario.  Unlike :func:`failure_recovery`'s near-zero floor, the
    engine quarantines the machine's LPs outright: queues freeze, busy
    jobs suspend mid-countdown, and the frozen local clocks hold GVT
    back until recovery, while each refinement round re-homes LPs off
    the dead machine via the partition game."""
    base = np.ones(num_machines, np.float32) if base is None \
        else np.asarray(base, np.float32)
    down = base.copy()
    down[machine] = 0.0
    if fail_tick == 0:        # down from the first tick: no base segment
        rows, times = [down], [0]
    else:
        rows, times = [base, down], [0, fail_tick]
    if recover_tick is not None:
        rows.append(base)
        times.append(recover_tick)
    return make_schedule(times, np.stack(rows), floor=0.0)


def refine_exchange_loss(num_rounds: int, num_shards: int, seed: int = 0, *,
                         p_lost: float = 0.2, max_lost: int = 3,
                         num_machines: int = 1, num_nodes: int = 0):
    """Refinement-layer exchange-loss scenario: a seeded
    :class:`repro_torch.distributed.faults.FaultPlan` where candidate
    exchanges are lost on the wire with probability ``p_lost`` per
    (round, shard) — each loss costs up to ``max_lost`` bounded retries
    before the round proceeds on the stale aggregate (DESIGN.md §15.2).
    Pass it as ``fault_plan=`` to any distributed driver; pair with
    :func:`true_failure` to measure load CV through both fault classes."""
    from ..distributed import faults
    return faults.make_fault_plan(
        num_rounds, num_shards, seed, p_lost=p_lost, max_lost=max_lost,
        num_machines=num_machines, num_nodes=num_nodes)


def pad_segments(schedule: SpeedSchedule, num_segments: int) -> SpeedSchedule:
    """Extend a schedule to ``num_segments`` by repeating its last row.

    The last segment extends forever, so appending copies of it at later
    tick boundaries is semantics-preserving: ``speeds_at`` returns the
    same (K,) vector at every tick.  This is how differently-shaped
    schedules become stackable for a batched DES run (DESIGN.md §12.4).
    """
    have = schedule.times.shape[0]
    if have > num_segments:
        raise ValueError(f"schedule already has {have} > {num_segments} "
                         "segments")
    if have == num_segments:
        return schedule
    extra = num_segments - have
    times = torch.cat([
        schedule.times,
        schedule.times[-1] + torch.arange(1, extra + 1, dtype=torch.int32,
                                          device=schedule.times.device)])
    speeds = torch.cat([schedule.speeds,
                        schedule.speeds[-1:].repeat(extra, 1)])
    return SpeedSchedule(times=times, speeds=speeds)


def stack_schedules(schedules) -> SpeedSchedule:
    """Stack B schedules into one ``SpeedSchedule`` with ``(B, S)`` times
    and ``(B, S, K)`` speeds, padding shorter ones via :func:`pad_segments`
    — the schedule operand of a batched DES run
    (:func:`repro_torch.des.engine.run_simulation_batch`, DESIGN.md §12.4)."""
    schedules = list(schedules)
    if not schedules:
        raise ValueError("cannot stack an empty sequence of schedules")
    ks = {s.num_machines for s in schedules}
    if len(ks) != 1:
        raise ValueError(f"schedules disagree on machine count: {sorted(ks)}")
    target = max(s.times.shape[0] for s in schedules)
    padded = [pad_segments(s, target) for s in schedules]
    return SpeedSchedule(
        times=torch.stack([s.times for s in padded]),
        speeds=torch.stack([s.speeds for s in padded]))


def random_churn(num_machines: int, num_segments: int, segment_ticks: int,
                 seed, low: float = 0.3, high: float = 1.0) -> SpeedSchedule:
    """Every ``segment_ticks`` ticks each machine's speed is re-drawn
    uniformly from [low, high] — sustained background churn."""
    if num_segments < 1 or segment_ticks < 1:
        raise ValueError("need >= 1 segment of >= 1 tick")
    rng = np.random.default_rng(seed)
    rows = rng.uniform(low, high,
                       size=(num_segments, num_machines)).astype(np.float32)
    times = np.arange(num_segments, dtype=np.int32) * segment_ticks
    return make_schedule(times, rows)
