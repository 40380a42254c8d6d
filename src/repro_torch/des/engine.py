"""Software archetype of an optimistic (Time Warp) parallel DES (paper §6 +
App. B), PyTorch port of ``repro.des.engine``.

One wall-clock tick is one vectorized pass over all LPs (DESIGN.md §3.1).
The model implements, faithfully to the paper's Fig. 3-6 pseudocode:

  * per-LP event lists / histories with ``event-tick`` wall-clock transfer
    delays (inter-machine > intra-machine — the rollback-risk mechanism),
  * optimistic execution: an idle LP picks its lowest-timestamp ready event
    and advances its local virtual time,
  * ``busy-time = (#LPs on my machine) x process_time(type)`` — the paper's
    machine-speed model (speed inversely proportional to resident LPs),
  * non-causal stragglers -> rollback: history entries with time > the
    straggler's timestamp are restored to the event list and re-executed,
  * anti-messages: a rolling-back LP sends a ROLLBACK event to its neighbors
    carrying the minimum invalidated child timestamp; the receiver cancels
    matching unprocessed events and cascades if it already processed them
    (classic rollback-announcement Time Warp, see DESIGN.md §3),
  * GVT = min(local times, event timestamps) and fossil collection of
    history entries older than GVT,
  * the limited-scope flooded packet-flow workload: completed events with
    hop count > 0 forward to every neighbor that has not yet seen the
    thread,
  * periodic partition refinement: every ``refine_freq`` ticks node/edge
    weights are measured from the live event lists (b_i = event-list length,
    c_ij = mutual pending-spawn counts, §6.1) and the game-theoretic
    refinement reassigns LPs to machines.

The deviations from the paper's prose are the reference's (DESIGN.md
§3/§8): one coalesced anti-message per (sender, receiver, epoch) and tick,
and the timestamp-aware flood dedup through ``seen_time``, recomputed from
the live records every tick.

How the port runs it
--------------------

Every tick runs on a stack of B simulations at once (a leading batch axis
on every state field); a lone run is the stack of one.  Ticks run in
chunks that end on the refinement cadence, and the host reads one flag per
``_SYNC_TICKS`` ticks — whether any simulation is still alive — and
nothing else.  A tick of a simulation that has drained (or reached
``max_ticks``) is a masked no-op, as the reference's batched
``while_loop`` select-masks it, so each final state, traces included,
equals the state its own tick-by-tick run reaches.

Every step is exact: integer counts are integer sums, per-(LP, thread)
minima are ``scatter_reduce`` minima, the anti-message coalescing is a
gather over each receiver's own (N, E) slots (never the (N, E, N) match of
the reference, whose memory dominates at size), and the insertion scatter
sends every rejected proposal to one dummy slot with one fill value.
Refinement rounds call :func:`repro_torch.core.refine.refine` (kernel 1 on
the card) for a lone run and :func:`repro_torch.core.batch.refine_batched`
(kernel 3) for a fleet; with ``refine_backend="distributed"``, each
element's round calls :func:`repro_torch.distributed.refine_distributed`.

Telemetry (``recorder=``, DESIGN.md §14) writes a lone run's tick rows on
the ``trace_stride`` cadence into a buffer on the device from inside the
(graph-captured) tick, completes a refinement tick's row after its round,
and reads the rows back when the buffer could fill and once at the end.
Without a recorder the ticks are exactly the recorder-free ones.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import costs as game_costs
from ..core.batch import (_map, refine_batched, stack_pytrees,
                          unstack_pytree)
from ..core.problem import PartitionProblem, resolve_device
from ..core.refine import refine
from ..distributed.runtime import refine_distributed
from ..obs.rows import TickRows, TurnRows, decode, read_back
from .scenarios import SpeedSchedule, segment_at, speeds_at

NORMAL = 0
ROLLBACK = 1

_INF = 3.0e38

# Ticks between the host's reads of the "any simulation alive" flag.
_SYNC_TICKS = 256

# Ticks in one CUDA graph of the run loop on the card.
_GRAPH_TICKS = 16

# Least capacity of a lone run's buffer of telemetry tick rows.
_TICK_ROWS = 4096

# Declared asymptotic budget for the DES tick, consumed by the
# complexity analyzers (``repro_torch.analysis``, DESIGN.md §18).  The
# engine consumes the dense (N, N) topology and gathers over (lp, slot,
# neighbour) windows, so a tick legitimately produces O(N^2)-shaped
# intermediates (event_capacity is a static constant, not a problem
# dimension).
DES_COMPLEXITY = {
    "mem": {"n": 2.0, "k": 1.0},
    "ops": {"n": 2.0, "k": 1.0},
}

@dataclasses.dataclass(frozen=True)
class DESConfig:
    num_lps: int
    num_machines: int
    num_threads: int
    event_capacity: int = 24
    history_capacity: int = 48
    proc_ticks: int = 2           # get_process_time(NORMAL) base cost
    inter_delay: int = 6          # event-tick for cross-machine transfer
    intra_delay: int = 1          # event-tick for same-machine transfer
    hop_sim_latency: float = 1.0  # simulation-time increment per hop
    max_ticks: int = 20_000
    # heterogeneous machines (DESIGN.md §11): relative per-machine speeds
    # (1.0 = nominal; busy-time divides by the resident machine's speed).
    # None = uniform.  A SpeedSchedule passed to run_simulation/des_tick
    # overrides this per tick (speed churn scenarios, des/scenarios.py).
    machine_speeds: tuple[float, ...] | None = None
    # partition refinement
    refine_freq: int = 0          # 0 = never refine
    refine_framework: str = game_costs.C_FRAMEWORK
    refine_max_turns: int = 256
    refine_mu: float = 8.0
    # "single" = the single-controller loop of core/refine.py;
    # "distributed" = the sharded runtime of repro_torch.distributed.
    refine_backend: str = "single"
    refine_num_shards: int = 0    # 0 = one shard per machine
    # the incremental aggregate-state path (DESIGN.md §10) by default;
    # refine_verify_every=M > 0 cross-checks the carried aggregate against
    # a rebuild every M turns of each refinement round.
    refine_incremental: bool = True
    refine_verify_every: int = 0
    # migration-aware hysteresis (DESIGN.md §11): an LP migrates only when
    # its dissatisfaction exceeds theta_i = refine_theta_scale * its live
    # state size (event-list + history occupancy — the records a migration
    # must ship).  0 = migration treated as free.
    refine_theta_scale: float = 0.0
    # transfer freeze: a migrated LP is frozen for
    # round(migration_freeze * state_size * inter_delay) wall ticks (the
    # state transfer it must wait for), so load traces reflect thrashing.
    # 0 = instantaneous migration.
    migration_freeze: float = 0.0
    # load trace (Figs 9/10)
    trace_stride: int = 50
    max_trace: int = 512


class EventLists(NamedTuple):
    time: torch.Tensor     # (N, E) f32 — simulation timestamp
    thread: torch.Tensor   # (N, E) i32 — flood-thread id (-1 for rollback)
    typ: torch.Tensor      # (N, E) i32 — NORMAL / ROLLBACK
    tick: torch.Tensor     # (N, E) i32 — wall ticks before processable
    count: torch.Tensor    # (N, E) i32 — remaining hop count (NORMAL) or
                           #              the invalidated send-epoch (ROLLBACK)
    sender: torch.Tensor   # (N, E) i32 — LP that sent the event (-1 = initial)
    epoch: torch.Tensor    # (N, E) i32 — sender's send-epoch when it left
    valid: torch.Tensor    # (N, E) bool


class History(NamedTuple):
    time: torch.Tensor     # (N, H) f32
    thread: torch.Tensor   # (N, H) i32
    count: torch.Tensor    # (N, H) i32
    sender: torch.Tensor   # (N, H) i32
    epoch: torch.Tensor    # (N, H) i32
    dup: torch.Tensor      # (N, H) bool — consumed as duplicate (never
                           #               processed/forwarded); revived if
                           #               the canonical copy is cancelled
    valid: torch.Tensor    # (N, H) bool


class DESState(NamedTuple):
    ev: EventLists
    hist: History
    local_time: torch.Tensor   # (N,) f32
    busy: torch.Tensor         # (N,) bool
    busy_tick: torch.Tensor    # (N,) i32
    cur_time: torch.Tensor     # (N,) f32 — event currently being processed
    cur_thread: torch.Tensor   # (N,) i32
    cur_count: torch.Tensor    # (N,) i32
    cur_sender: torch.Tensor   # (N,) i32 — sender of the event in process
    machine: torch.Tensor      # (N,) i32
    seen_time: torch.Tensor    # (N, T) f32 — earliest receipt (_INF = never)
    epoch: torch.Tensor        # (N,) i32 — per-LP send epoch; bumped on
                               #            every rollback so anti-messages
                               #            cancel ONLY messages sent before
    tick: torch.Tensor         # ()  i32 — wall clock
    gvt: torch.Tensor          # ()  f32 — global virtual time
    done: torch.Tensor         # ()  bool
    # statistics
    rollbacks: torch.Tensor    # () i32 — straggler + anti-message rollbacks
    processed: torch.Tensor    # () i32 — events processed to completion
    dropped: torch.Tensor      # () i32 — proposals dropped for capacity
    hist_evict: torch.Tensor   # () i32 — history evictions (should be 0)
    refines: torch.Tensor      # () i32 — refinement rounds executed
    moves: torch.Tensor        # () i32 — LP migrations applied
    # load trace (Figs 9/10): mean event-list length per machine over time
    trace: torch.Tensor        # (max_trace, K) f32
    # speed-normalized machine backlog Q_k / w_k at the same trace ticks
    trace_wload: torch.Tensor  # (max_trace, K) f32
    trace_ptr: torch.Tensor    # () i32

    @property
    def seen(self) -> torch.Tensor:
        """(N, T) bool — which LPs have (validly) received each thread."""
        return self.seen_time < _INF / 2


def make_initial_state(cfg: DESConfig, machine0, thread_src, thread_time,
                       thread_count, device=None) -> DESState:
    """Seed each flood thread into its source LP's event list at t=0, on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    N, E, H, T = (cfg.num_lps, cfg.event_capacity, cfg.history_capacity,
                  cfg.num_threads)
    K = cfg.num_machines

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # place thread t into slot = running count of earlier threads at the
    # same source (the workload generator guarantees counts fit in E)
    src = torch.as_tensor(np.asarray(thread_src, np.int32), device=dev)
    tids = torch.arange(T, device=dev)
    slots = torch.sum((src[None, :] == src[:, None])
                      & (tids[None, :] < tids[:, None]), dim=1)
    at = (src.long(), slots)
    time = full((N, E), _INF, torch.float32)
    time[at] = torch.as_tensor(np.asarray(thread_time, np.float32),
                               device=dev)
    thread = full((N, E), -1, torch.int32)
    thread[at] = tids.to(torch.int32)
    count = full((N, E), 0, torch.int32)
    count[at] = torch.as_tensor(np.asarray(thread_count, np.int32),
                                device=dev)
    valid = full((N, E), False, torch.bool)
    valid[at] = True
    ev = EventLists(time=time, thread=thread,
                    typ=full((N, E), 0, torch.int32),
                    tick=full((N, E), 0, torch.int32), count=count,
                    sender=full((N, E), -1, torch.int32),
                    epoch=full((N, E), 0, torch.int32), valid=valid)
    hist = History(time=full((N, H), _INF, torch.float32),
                   thread=full((N, H), -1, torch.int32),
                   count=full((N, H), 0, torch.int32),
                   sender=full((N, H), -1, torch.int32),
                   epoch=full((N, H), 0, torch.int32),
                   dup=full((N, H), False, torch.bool),
                   valid=full((N, H), False, torch.bool))
    if isinstance(machine0, torch.Tensor):
        machine = machine0.to(device=dev, dtype=torch.int32)
    else:
        machine = torch.as_tensor(np.asarray(machine0, np.int32), device=dev)
    i32 = torch.int32
    return DESState(
        ev=ev, hist=hist,
        local_time=full((N,), 0.0, torch.float32),
        busy=full((N,), False, torch.bool),
        busy_tick=full((N,), 0, i32),
        cur_time=full((N,), _INF, torch.float32),
        cur_thread=full((N,), -1, i32),
        cur_count=full((N,), 0, i32),
        cur_sender=full((N,), -1, i32),
        machine=machine,
        # seen_time starts unknown everywhere; the injected records define
        # the sources' receipt times (recomputed every tick)
        seen_time=full((N, T), _INF, torch.float32),
        epoch=full((N,), 0, i32),
        tick=full((), 0, i32), gvt=full((), 0.0, torch.float32),
        done=full((), False, torch.bool),
        rollbacks=full((), 0, i32), processed=full((), 0, i32),
        dropped=full((), 0, i32), hist_evict=full((), 0, i32),
        refines=full((), 0, i32), moves=full((), 0, i32),
        trace=full((cfg.max_trace, K), 0.0, torch.float32),
        trace_wload=full((cfg.max_trace, K), 0.0, torch.float32),
        trace_ptr=full((), 0, i32))


# ---------------------------------------------------------------------------
# One wall-clock tick over a stack of B simulations
# ---------------------------------------------------------------------------

def _base_speeds(cfg: DESConfig, device) -> torch.Tensor:
    """(K,) static relative machine speeds from the config (1.0 = nominal)."""
    if cfg.machine_speeds is None:
        return torch.ones(cfg.num_machines, device=device)
    if len(cfg.machine_speeds) != cfg.num_machines:
        raise ValueError(
            f"machine_speeds has {len(cfg.machine_speeds)} entries for "
            f"{cfg.num_machines} machines")
    return torch.as_tensor(np.asarray(cfg.machine_speeds, np.float32),
                           device=device)


def _live_state_size(state: DESState) -> torch.Tensor:
    """(..., N) per-LP live state size: event-list + history occupancy —
    the records a migration must ship (sizes theta and the freeze)."""
    return (torch.sum(state.ev.valid, dim=-1)
            + torch.sum(state.hist.valid, dim=-1)).to(torch.float32)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when there is none),
    as ``jnp.argmax`` of a boolean picks it."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    first = torch.where(mask, idx, n).min(dim=-1).values
    return torch.where(first < n, first, 0)


def _first_max(x: torch.Tensor) -> torch.Tensor:
    return _first(x == x.max(dim=-1, keepdim=True).values)


def _first_min(x: torch.Tensor) -> torch.Tensor:
    return _first(x == x.min(dim=-1, keepdim=True).values)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the last axis, one index per row."""
    return x.gather(-1, idx.long()[..., None])[..., 0]


def _put(x: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """x with x[..., idx] = value along the last axis, one index per row."""
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return x.scatter(-1, idx.long()[..., None],
                     value.expand(idx.shape)[..., None])


def _thread_min(valid, thread, time, num_threads: int) -> torch.Tensor:
    """(..., N, T): per LP and thread, the least ``time`` over the valid
    slots holding that thread (_INF where none) — a ``scatter_reduce``
    minimum, exact in any order."""
    keep = valid & (thread >= 0)
    idx = torch.where(keep, thread, num_threads).long()
    out = torch.full((*thread.shape[:-1], num_threads + 1), _INF,
                     dtype=time.dtype, device=time.device)
    out.scatter_reduce_(-1, idx, time, "amin")
    return out[..., :num_threads]


def _thread_any(mask, thread, num_threads: int) -> torch.Tensor:
    """(..., N, T): per LP and thread, whether a masked slot holds it."""
    idx = torch.where(mask & (thread >= 0), thread, num_threads).long()
    out = torch.zeros((*thread.shape[:-1], num_threads + 1),
                      dtype=torch.bool, device=thread.device)
    out.scatter_(-1, idx, True)
    return out[..., :num_threads]


def _select_events(ev: EventLists, idle: torch.Tensor):
    """Per LP: pick the lowest-timestamp ready event (tick == 0); among ties
    prefer ROLLBACK events, then the lowest slot.  Returns (has, slot)."""
    ready = ev.valid & (ev.tick == 0)
    ts = torch.where(ready, ev.time, _INF)
    mints = ts.min(dim=-1).values
    has = idle & (mints < _INF)
    E = ev.time.shape[-1]
    cand = ready & (ts <= mints[..., None])
    slots = torch.arange(E, device=ev.time.device)
    score = torch.where(cand, (ev.typ == ROLLBACK).to(torch.int32) * (2 * E)
                        + (E - 1 - slots), -1)
    return has, _first_max(score)


def _rollback_slots(ev: EventLists, ann_epoch: torch.Tensor):
    """Per receiver R and sender S: whether R's event list holds a ROLLBACK
    event from S carrying S's current epoch, and its first slot.

    The reference matches every (R, slot, S) triple, an (N, E, N) mask;
    here each slot's own sender is looked up instead, and the first slot
    per (R, S) is a ``scatter_reduce`` minimum over (R, slot).  Returns
    ``(match (B, N, E), first (B, N, N))`` with ``first[R, S] = E`` where
    there is none."""
    n, e = ev.sender.shape[-2:]
    sender = ev.sender.long().clamp(min=0)
    epoch_of_sender = ann_epoch.gather(-1, sender.flatten(-2)).view(
        ev.sender.shape)
    match = (ev.valid & (ev.typ == ROLLBACK) & (ev.sender >= 0)
             & (ev.count == epoch_of_sender))
    idx = torch.where(match, sender, n)
    slot = torch.arange(e, device=ev.time.device).expand(ev.sender.shape)
    first = torch.full((*ev.sender.shape[:-1], n + 1), e, dtype=torch.int64,
                       device=ev.time.device)
    first.scatter_reduce_(-1, idx, slot, "amin")
    return match, first[..., :n]


def _coalesce(ev: EventLists, ann_pair, ann_time, ann_epoch):
    """Coalesce announcements: where a receiver already holds a ROLLBACK
    event from the same sender *and the same epoch*, lower its threshold
    in place instead of queueing a second one.  Returns the event lists
    and the announcement pairs still to send, (B, S, R)."""
    match, first = _rollback_slots(ev, ann_epoch)
    has_rb = first < ev.time.shape[-1]                    # (B, R, S)
    coalesce = ann_pair.transpose(-1, -2) & has_rb        # (B, R, S)
    sender = ev.sender.long().clamp(min=0)
    slot = torch.arange(ev.time.shape[-1], device=ev.time.device)
    hit = (match & (first.gather(-1, sender) == slot)
           & coalesce.gather(-1, sender))
    lowered = torch.minimum(
        ev.time, ann_time.gather(-1, sender.flatten(-2)).view(sender.shape))
    ev = ev._replace(time=torch.where(hit, lowered, ev.time))
    return ev, ann_pair & ~coalesce.transpose(-1, -2)


def _machine_counts(machine: torch.Tensor, k: int,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """(B, K) integer per-machine sums: resident LPs, or ``weights``."""
    onehot = machine.long()[..., None] == torch.arange(k,
                                                       device=machine.device)
    if weights is None:
        return torch.sum(onehot, dim=-2)
    return torch.sum(onehot * weights.long()[..., None], dim=-2)


def _tick(cfg: DESConfig, nbr: torch.Tensor, s: DESState,
          speeds: torch.Tensor) -> DESState:
    """Phases P0-P5 of one tick over a stack: every field of ``s`` has a
    leading B axis, ``nbr`` is (B, N, N) bool and ``speeds`` (B, K)."""
    N, E, H = cfg.num_lps, cfg.event_capacity, cfg.history_capacity
    K, T = cfg.num_machines, cfg.num_threads
    dev = s.machine.device
    i32 = torch.int32
    ev, hist = s.ev, s.hist
    machine = s.machine.long()
    lp_speed = speeds.gather(-1, machine)                       # (B, N)
    # speed <= 0 means "machine down" (DESIGN.md §15.5): its LPs are
    # quarantined — no selection, no countdown, no completions
    lp_down = lp_speed <= 0.0

    # ---- P0: transfer-delay countdown (only events already in lists) -----
    ev = ev._replace(tick=torch.clamp(
        ev.tick - (ev.valid & (ev.tick > 0)).to(i32), min=0))

    # ---- P0b: recompute seen_time from the live records ------------------
    gvt0 = s.gvt[:, None, None]
    perm = torch.where(s.seen_time < gvt0, s.seen_time, _INF)
    seen_time = torch.minimum(
        torch.minimum(_thread_min(ev.valid, ev.thread, ev.time, T),
                      _thread_min(hist.valid, hist.thread, hist.time, T)),
        perm)

    # ---- P1: busy LPs advance; completions forward the flood -------------
    was_busy = s.busy
    busy_tick = torch.where(was_busy & ~lp_down, s.busy_tick - 1,
                            s.busy_tick)
    completed = was_busy & ~lp_down & (busy_tick <= 0)
    still_busy = was_busy & ~completed
    # transfer-freeze completions (cur_thread == -1) release the LP without
    # counting as processed
    processed = s.processed + torch.sum(
        (completed & (s.cur_thread >= 0)).to(i32), dim=-1, dtype=i32)
    fwd_send = completed & (s.cur_count > 0)
    fwd_thread = s.cur_thread
    fwd_time = s.cur_time + cfg.hop_sim_latency
    fwd_count = s.cur_count - 1

    # ---- P2: idle LPs select and locally handle one event ----------------
    idle = ~was_busy & ~lp_down
    has, slot = _select_events(ev, idle)
    sel_time = _take(ev.time, slot)
    sel_thread = _take(ev.thread, slot)
    sel_typ = _take(ev.typ, slot)
    sel_count = _take(ev.count, slot)
    sel_sender = _take(ev.sender, slot)
    sel_epoch = _take(ev.epoch, slot)

    # duplicate: a strictly earlier copy of this thread is already known
    sel_seen = _take(seen_time, sel_thread.clamp(min=0))
    dup = has & (sel_typ == NORMAL) & (sel_time > sel_seen + 1e-6)
    is_rb = has & (sel_typ == ROLLBACK)
    normal = has & (sel_typ == NORMAL) & ~dup & (sel_time >= s.local_time)
    straggler = has & (sel_typ == NORMAL) & ~dup & (sel_time < s.local_time)

    # consume the selected slot
    ev = ev._replace(valid=_put(ev.valid, slot,
                                _take(ev.valid, slot) & ~has))

    # -- rollback-event handling (anti-message with threshold sel_time) ---
    rb_epoch = sel_count[..., None]
    threshold = sel_time[..., None] - 1e-6
    cancel_ev = (is_rb[..., None] & ev.valid
                 & (ev.sender == sel_sender[..., None])
                 & (ev.typ == NORMAL) & (ev.epoch <= rb_epoch)
                 & (ev.time >= threshold))
    cancel_hist = (is_rb[..., None] & hist.valid
                   & (hist.sender == sel_sender[..., None])
                   & (hist.epoch <= rb_epoch) & (hist.time >= threshold))
    any_casc = torch.any(cancel_hist, dim=-1)
    t_inv = torch.where(cancel_hist, hist.time, _INF).min(dim=-1).values
    restore = torch.where(
        straggler[..., None], hist.valid & (hist.time > sel_time[..., None]),
        (is_rb & any_casc)[..., None] & hist.valid
        & (hist.time >= t_inv[..., None]) & ~cancel_hist)
    rolled_back = straggler | (is_rb & any_casc)
    rollbacks = s.rollbacks + torch.sum(rolled_back.to(i32), dim=-1,
                                        dtype=i32)

    # duplicate revival: a surviving duplicate of a cancelled thread
    # becomes a candidate canonical again
    cancelled_threads = (_thread_any(cancel_ev, ev.thread, T)
                         | _thread_any(cancel_hist, hist.thread, T))
    revive = (hist.valid & hist.dup & (hist.thread >= 0) & ~cancel_hist
              & cancelled_threads.gather(-1, hist.thread.long().clamp(min=0)))
    restore = restore | revive

    # announcements: min invalidated *child* timestamp per rolling-back LP
    inval = (restore | cancel_hist) & (hist.count > 0) & ~hist.dup
    ann_time = torch.where(inval, hist.time, _INF).min(dim=-1).values \
        + cfg.hop_sim_latency
    ann_send = rolled_back & torch.any(inval, dim=-1)
    ann_epoch = s.epoch
    new_epoch = s.epoch + rolled_back.to(i32)

    ev = ev._replace(valid=ev.valid & ~cancel_ev)
    hist = hist._replace(valid=hist.valid & ~cancel_hist & ~restore)

    # -- start processing (normal + straggler) -----------------------------
    starts = normal | straggler
    nlps = _machine_counts(s.machine, K)                         # (B, K)
    live_speed = torch.where(lp_speed > 0.0, lp_speed, 1.0)
    busy_cost = torch.clamp(torch.ceil(
        (nlps.gather(-1, machine) * cfg.proc_ticks).to(torch.float32)
        / live_speed).to(i32), min=1)
    busy = still_busy | starts
    busy_tick = torch.where(starts, busy_cost, busy_tick)
    cur_time = torch.where(starts, sel_time, s.cur_time)
    cur_thread = torch.where(starts, sel_thread, s.cur_thread)
    cur_count = torch.where(starts, sel_count, s.cur_count)
    cur_sender = torch.where(starts, sel_sender, s.cur_sender)
    local_time = torch.where(starts, sel_time, s.local_time)
    local_time = torch.where(is_rb & any_casc,
                             torch.minimum(local_time, t_inv), local_time)

    # push started + duplicate events into history (first free slot; evict
    # oldest if full)
    free_h = ~hist.valid
    has_free = torch.any(free_h, dim=-1)
    oldest = _first_min(torch.where(hist.valid, hist.time, _INF))
    hslot = torch.where(has_free, _first(free_h), oldest)
    put = starts | dup
    hist_evict = s.hist_evict + torch.sum((put & ~has_free).to(i32),
                                          dim=-1, dtype=i32)

    def pushed(field, value):
        return _put(field, hslot, torch.where(put, value,
                                              _take(field, hslot)))

    hist = History(time=pushed(hist.time, sel_time),
                   thread=pushed(hist.thread, sel_thread),
                   count=pushed(hist.count, sel_count),
                   sender=pushed(hist.sender, sel_sender),
                   epoch=pushed(hist.epoch, sel_epoch),
                   dup=pushed(hist.dup, dup),
                   valid=pushed(hist.valid, torch.ones_like(put)))

    # ---- P3: proposals (forwards + announcements + self-restores) --------
    lps = torch.arange(N, device=dev)
    # forwards: always re-forward except (a) back along the edge the copy
    # arrived on and (b) to a receiver whose earliest receipt is older
    # than GVT (permanent)
    fwd_pair = fwd_send[..., None] & nbr                        # (B, S, R)
    fwd_pair = fwd_pair & (lps != cur_sender[..., None])
    perm_seen = torch.where(seen_time < gvt0, seen_time, _INF)  # (B, R, T)
    recv_perm = perm_seen.transpose(-1, -2).gather(
        -2, fwd_thread.long().clamp(min=0)[..., None].expand(-1, -1, N))
    fwd_pair = fwd_pair & ~(recv_perm <= fwd_time[..., None] + 1e-6)
    ann_pair = ann_send[..., None] & nbr                        # (B, S, R)
    ev, ann_pair = _coalesce(ev, ann_pair, ann_time, ann_epoch)

    # ---- P4: capacity-ranked insertion -----------------------------------
    # Receiver R's proposals in the reference's order: one from each sender
    # row S (a forward or an announcement), then R's own restored history
    # slots.  The first min(#proposals, #free slots) are accepted, the j-th
    # into R's j-th free slot (ascending); the rest are dropped.  The j-th
    # proposal is found by a binary search of R's running count, so each
    # free slot receives one gathered value and nothing else is written.
    sent_t = (fwd_pair | ann_pair).transpose(-1, -2)            # (B, R, S)
    running = torch.cumsum(torch.cat([sent_t, restore], dim=-1), dim=-1,
                           dtype=i32)                           # (B, R, P)
    total = running[..., -1]
    free = ~ev.valid                                            # (B, R, E)
    n_acc = torch.minimum(total, torch.sum(free, dim=-1))
    dropped = s.dropped + torch.sum(total - n_acc, dim=-1, dtype=i32)
    ev_slots = torch.arange(E, device=dev)
    free_pos = torch.argsort(torch.where(free, ev_slots, E + ev_slots),
                             dim=-1, stable=True)               # (B, R, E)
    take = ev_slots < n_acc[..., None]
    rank = (ev_slots + 1).to(i32).expand_as(free_pos).contiguous()
    p = torch.searchsorted(running, rank).clamp(max=N + H - 1)  # (B, R, E)
    from_sender = p < N
    src = p.clamp(max=N - 1)
    h = (p - N).clamp(min=0)

    def of_sender(vec):                  # vec[S] for each (R, j)
        return vec.gather(-1, src.flatten(-2)).view(src.shape)

    def of_history(field):               # field[R, h] for each (R, j)
        return field.gather(-1, h)

    is_fwd = fwd_pair.transpose(-1, -2).gather(-1, src)
    link_tick = torch.where(of_sender(s.machine) == s.machine[..., None],
                            cfg.intra_delay, cfg.inter_delay).to(i32)
    old = s.hist
    # forwards carry the sender's post-rollback epoch; restores keep the
    # original message's epoch so later anti-messages still match them
    arrivals = EventLists(
        time=torch.where(from_sender,
                         torch.where(is_fwd, of_sender(fwd_time),
                                     of_sender(ann_time)),
                         of_history(old.time)),
        thread=torch.where(from_sender,
                           torch.where(is_fwd, of_sender(fwd_thread), -1),
                           of_history(old.thread)),
        typ=torch.where(from_sender & ~is_fwd, ROLLBACK, NORMAL).to(i32),
        tick=torch.where(from_sender, link_tick, 0),
        count=torch.where(from_sender,       # an announcement: its epoch
                          torch.where(is_fwd, of_sender(fwd_count),
                                      of_sender(ann_epoch)),
                          of_history(old.count)),
        sender=torch.where(from_sender, src.to(i32), of_history(old.sender)),
        epoch=torch.where(from_sender, of_sender(new_epoch),
                          of_history(old.epoch)),
        valid=torch.ones_like(take))
    ev = EventLists(*(
        field.scatter(-1, free_pos,
                      torch.where(take, new, field.gather(-1, free_pos)))
        for field, new in zip(ev, arrivals)))

    # ---- P5: GVT, fossil collection, termination, trace ------------------
    ev_min = torch.where(ev.valid, ev.time, _INF).flatten(-2).min(-1).values
    busy_min = torch.where(busy, cur_time, _INF).min(dim=-1).values
    lt_min = local_time.min(dim=-1).values
    gvt = torch.minimum(torch.minimum(ev_min, busy_min), lt_min)
    hist = hist._replace(valid=hist.valid & (hist.time >= gvt[:, None, None]))
    done = ~torch.any(ev.valid.flatten(-2), dim=-1) & ~torch.any(busy, dim=-1)

    tick = s.tick + 1
    lens = torch.sum(ev.valid, dim=-1)
    nlps_f = torch.clamp(nlps.to(torch.float32), min=1.0)
    total_len = _machine_counts(s.machine, K, lens).to(torch.float32)
    mean_len = total_len / nlps_f
    wload = total_len / torch.clamp(speeds, min=1e-6)
    # the trace stops (rather than overwriting its last row) once full
    do_trace = (tick % cfg.trace_stride == 0) & (s.trace_ptr < cfg.max_trace)
    ptr = torch.clamp(s.trace_ptr, 0, cfg.max_trace - 1).long()
    row = ptr[:, None, None].expand(-1, 1, K)

    def traced(trace, value):
        return torch.where(do_trace[:, None, None],
                           trace.scatter(1, row, value[:, None, :]), trace)

    return s._replace(
        ev=ev, hist=hist, local_time=local_time, busy=busy,
        busy_tick=busy_tick, cur_time=cur_time, cur_thread=cur_thread,
        cur_count=cur_count, cur_sender=cur_sender, seen_time=seen_time,
        epoch=new_epoch, tick=tick, gvt=gvt, done=done,
        rollbacks=rollbacks, processed=processed, dropped=dropped,
        hist_evict=hist_evict, trace=traced(s.trace, mean_len),
        trace_wload=traced(s.trace_wload, wload),
        trace_ptr=torch.clamp(s.trace_ptr + do_trace.to(i32),
                              max=cfg.max_trace))


def _where(pred: torch.Tensor, new, old):
    """Field by field ``new`` where the (B,) ``pred`` holds, else ``old``."""
    return _map(lambda a, b: torch.where(
        pred.view(-1, *([1] * (a.ndim - 1))), a, b), new, old)


def _alive(cfg: DESConfig, s: DESState) -> torch.Tensor:
    return ~s.done & (s.tick < cfg.max_ticks)


# ---------------------------------------------------------------------------
# Partition refinement (the paper's contribution)
# ---------------------------------------------------------------------------

def _refine_problem(cfg: DESConfig, nbr: torch.Tensor, s: DESState,
                    speeds: torch.Tensor):
    """The partition game a refinement round plays, measured from the live
    event lists (§6.1), for a stack: a stacked :class:`PartitionProblem`
    (adjacency (B, N, N), node weights (B, N), speeds (B, K), mu (B,))
    and the (B, N) hysteresis threshold or ``None``.

    ``speeds`` are the LIVE relative machine speeds of the tick, normalized
    into the game's ``w_k`` by a sum in machine order (the reference's)."""
    b = torch.sum(s.ev.valid, dim=-1).to(torch.float32)
    spawn = torch.sum(s.ev.valid & (s.ev.count > 0), dim=-1).to(torch.float32)
    c = nbr.to(torch.float32) * (spawn[..., :, None] + spawn[..., None, :])
    live = torch.clamp(speeds.to(torch.float32), min=1e-6)
    problem = PartitionProblem(
        adjacency=c, node_weights=b, speeds=live / game_costs.row_sum(live),
        mu=torch.full(b.shape[:1], cfg.refine_mu, device=b.device))
    theta = cfg.refine_theta_scale * _live_state_size(s) \
        if cfg.refine_theta_scale > 0 else None
    return problem, theta


def _check_backend(cfg: DESConfig, dissat_fn=None) -> None:
    if cfg.refine_freq <= 0 or cfg.refine_backend == "single":
        return
    if cfg.refine_backend == "distributed":
        if dissat_fn is not None:
            raise ValueError(
                "dissat_fn is the single backend's seam; "
                "refine_backend='distributed' reduces through "
                "refine_distributed's own shard reduction")
        return
    raise ValueError(f"unknown refine_backend {cfg.refine_backend!r}")


# A telemetry tick row: t, gvt, processed, rollbacks, refines, moves, mean
# backlog, weighted-backlog CV, speed segment, frozen LPs (the reference's
# ``emit_tick`` columns); a refinement row: t, moves, frozen.
_TICK_ROW = "ifiiiiffii"
_REFINE_ROW = "iii"


def _tick_row(cfg: DESConfig, s: DESState, new: DESState, speeds,
              segment) -> tuple:
    """The reference's tick row, one (B,) tensor a column, of the tick
    ``s`` → ``new`` run at ``speeds`` (B, K) in speed segment ``segment``
    (B,): the backlog per machine of the LPs' pre-tick machines, its mean
    over machines, and the CV ``std / max(mean, 1e-12)`` (f32, population
    std) of the speed-normalized backlog."""
    k = cfg.num_machines
    lens = torch.sum(new.ev.valid, dim=-1)
    total_len = _machine_counts(s.machine, k, lens).to(torch.float32)
    nlps_f = torch.clamp(_machine_counts(s.machine, k).to(torch.float32),
                         min=1.0)
    mean_len = total_len / nlps_f
    wload = total_len / torch.clamp(speeds, min=1e-6)
    cv = torch.std(wload, dim=-1, unbiased=False) \
        / torch.clamp(torch.mean(wload, dim=-1), min=1e-12)
    return (new.tick, new.gvt, new.processed, new.rollbacks, new.refines,
            new.moves, torch.mean(mean_len, dim=-1), cv, segment,
            _frozen(new))


def _segments(sched: SpeedSchedule | None, tick: torch.Tensor):
    """(B,) speed segments in effect at the (B,) ``tick``: 0 throughout
    without a schedule, as the reference records them."""
    return torch.zeros_like(tick) if sched is None \
        else segment_at(sched, tick)


def _frozen(s: DESState) -> torch.Tensor:
    """(B,) LPs pinned by a migration freeze (busy with the no-op
    marker)."""
    return torch.sum(s.busy & (s.cur_thread == -1), dim=-1,
                     dtype=torch.int32)


def _refine_row(cfg: DESConfig, s: DESState, after: DESState) -> tuple:
    """The reference's ``des_refine`` row of a round taking ``s`` to
    ``after``: the tick, the LPs moved, the LPs the round froze."""
    moved = after.machine != s.machine
    if cfg.migration_freeze > 0:
        freeze = torch.round(cfg.migration_freeze * _live_state_size(s)
                             * cfg.inter_delay).to(torch.int32)
        frozen = torch.sum(moved & (freeze > 0), dim=-1, dtype=torch.int32)
    else:
        frozen = torch.zeros_like(after.tick)
    return (after.tick, torch.sum(moved, dim=-1, dtype=torch.int32), frozen)


class _Telemetry:
    """A lone run's telemetry on the device: the tick rows (written inside
    the tick, see :class:`_Ticks`), the refinement rows, how many tick
    rows may have been written since the last read-back, and the run's
    speed schedule."""

    def __init__(self, cfg: DESConfig, period: int,
                 sched: SpeedSchedule | None, tick: torch.Tensor,
                 capacity: int):
        self.per_chunk = period // cfg.trace_stride + 1
        self.ticks = TickRows(max(capacity, self.per_chunk),
                              len(_TICK_ROW), tick.device)
        self.refines = TurnRows()
        self.pending = 0
        self.sched = sched

    def before_chunk(self) -> None:
        """Read the tick rows back if the next chunk could fill the
        buffer."""
        if self.pending + self.per_chunk > self.ticks.capacity:
            self.ticks.drain()
            self.pending = 0
        self.pending += self.per_chunk

    def after_round(self, cfg: DESConfig, s: DESState,
                    after: DESState) -> None:
        """Record a refinement round (``s`` → ``after``) and complete the
        row of its tick: the round's refines, moves and frozen LPs."""
        row = _refine_row(cfg, s, after)
        self.refines.append(*(x[0] for x in row))
        self.ticks.patch_last(after.tick[0], {4: after.refines[0],
                                              5: after.moves[0],
                                              9: _frozen(after)[0]})

    def take(self, final: DESState):
        """Every row and ``final``'s element-0 counters, read back in one
        transfer: ``(tick rows, refinement rows, counters)``."""
        counters = [final.moves[0], final.tick[0], final.done[0],
                    final.processed[0], final.rollbacks[0],
                    final.refines[0], final.gvt[0]]
        extra = self.ticks.drain(
            self.refines.tensor(len(_REFINE_ROW), final.tick.device),
            *counters)
        return self.ticks.rows(), extra[0], extra[1:]


def _refine_partition(cfg: DESConfig, nbr: torch.Tensor, s: DESState,
                      speeds: torch.Tensor, batched: bool,
                      dissat_fn=None) -> DESState:
    """One refinement round on every element of the stack ``s``: measure
    the game from the live event lists, refine, apply the migrations and,
    with ``migration_freeze > 0``, their transfer freezes (DESIGN.md §11).

    ``batched=False`` (a lone run, B = 1) refines through ``refine``
    (kernel 1 on the card); ``batched=True`` through ``refine_batched``
    (kernel 3), each element bitwise its lone round.  ``dissat_fn`` is the
    9-argument seam of the chosen entry point (``None``: its kernel).

    ``refine_backend="distributed"`` refines each element through
    :func:`~repro_torch.distributed.runtime.refine_distributed` (one shard
    per machine unless ``refine_num_shards`` says otherwise; kernel 3 over
    the shard stack on the card), one element after another, so a fleet's
    element is bitwise its lone run; like the reference's, the round takes
    no ``verify_every``."""
    problem, theta = _refine_problem(cfg, nbr, s, speeds)
    if cfg.refine_backend == "distributed":
        rows = []
        for b in range(s.machine.shape[0]):
            res = refine_distributed(
                unstack_pytree(problem, b), s.machine[b],
                cfg.refine_framework,
                num_shards=cfg.refine_num_shards or cfg.num_machines,
                max_turns=cfg.refine_max_turns,
                incremental=cfg.refine_incremental,
                theta=None if theta is None else theta[b])
            rows.append(res.assignment)
        assignment = torch.stack(rows)
        return _apply_migrations(cfg, s, assignment)
    kwargs = dict(max_turns=cfg.refine_max_turns,
                  incremental=cfg.refine_incremental,
                  verify_every=cfg.refine_verify_every,
                  dissat_fn=dissat_fn)
    if batched:
        res = refine_batched(problem, s.machine, cfg.refine_framework,
                             theta=theta, **kwargs)
        assignment = res.assignment
    else:
        one = unstack_pytree(problem, 0)
        res = refine(one, s.machine[0], cfg.refine_framework,
                     theta=None if theta is None else theta[0], **kwargs)
        assignment = res.assignment[None]
    return _apply_migrations(cfg, s, assignment)


def _apply_migrations(cfg: DESConfig, s: DESState,
                      assignment: torch.Tensor) -> DESState:
    """The stack after a refinement round chose ``assignment``: the
    machines, the round and move counts, and the transfer freezes."""
    moved = assignment != s.machine
    i32 = torch.int32
    new = s._replace(machine=assignment, refines=s.refines + 1,
                     moves=s.moves + torch.sum(moved.to(i32), dim=-1,
                                               dtype=i32))
    if cfg.migration_freeze > 0:
        # the state transfer freezes the migrated LP for ticks proportional
        # to (records shipped) x (inter-machine delay); an LP mid-event
        # finishes that much later, an idle LP becomes busy with a no-op
        # marker (cur_thread = -1: no forward, not counted processed)
        freeze = torch.round(cfg.migration_freeze * _live_state_size(s)
                             * cfg.inter_delay).to(i32)
        frozen = moved & (freeze > 0)
        newly_busy = frozen & ~s.busy
        new = new._replace(
            busy=s.busy | frozen,
            busy_tick=torch.where(frozen & s.busy, s.busy_tick + freeze,
                                  torch.where(newly_busy, freeze,
                                              s.busy_tick)),
            cur_time=torch.where(newly_busy, s.local_time, s.cur_time),
            cur_thread=torch.where(newly_busy, -1, s.cur_thread),
            cur_count=torch.where(newly_busy, 0, s.cur_count),
            cur_sender=torch.where(newly_busy, -1, s.cur_sender))
    return new


def _refine_where(cfg, nbr, s: DESState, speeds, pred: list[bool],
                  batched: bool, dissat_fn) -> DESState:
    """Refine the elements of the stack with ``pred`` (host booleans); the
    others keep their state bitwise."""
    idx = [b for b, p in enumerate(pred) if p]
    if not idx:
        return s
    if len(idx) == len(pred):
        return _refine_partition(cfg, nbr, s, speeds, batched, dissat_fn)
    sel = torch.tensor(idx, device=nbr.device)
    sub = _refine_partition(
        cfg, nbr.index_select(0, sel),
        _map(lambda t: t.index_select(0, sel), s),
        speeds.index_select(0, sel), batched, dissat_fn)
    return _map(lambda t, u: t.index_copy(0, sel, u), s, sub)


# ---------------------------------------------------------------------------
# The run loop over a stack
# ---------------------------------------------------------------------------

def _speeds_fn(cfg, s: DESState, sched: SpeedSchedule | None):
    """A function of the (B,) wall-clock ticks giving the (B, K) speeds in
    effect then: the stacked schedule's, or the config's throughout."""
    if sched is not None:
        return lambda tick: speeds_at(sched, tick)
    base = _base_speeds(cfg, s.tick.device).expand(s.tick.shape[0], -1)
    return lambda tick: base


class _Ticks:
    """Advances a stack tick by tick.

    On the CPU each tick runs eagerly.  On the card a tick is ~500 small
    launches, which the host issues slower than the card runs them, so
    ``graph_ticks`` masked ticks are captured once in a CUDA graph that
    reads and writes one set of state buffers, and replayed: the same
    kernels on the same values, so every state is bitwise the eager one
    (``graph_ticks=0``: every tick eager on the card too).  ``state``
    reads the buffers; assigning it copies into them.

    ``tel`` (telemetry, a lone run) takes each live tick's row on the
    ``trace_stride`` cadence, written by the step itself — so a captured
    graph writes it too."""

    def __init__(self, cfg: DESConfig, nbr, state: DESState, speeds_of,
                 graph_ticks: int = _GRAPH_TICKS,
                 tel: _Telemetry | None = None):
        def step(s):
            live = _alive(cfg, s)
            speeds = speeds_of(s.tick)
            new = _where(live, _tick(cfg, nbr, s, speeds), s)
            if tel is not None:
                row = _tick_row(cfg, s, new, speeds,
                                _segments(tel.sched, s.tick))
                tel.ticks.write(
                    live[0] & (new.tick[0] % cfg.trace_stride == 0),
                    *(x[0] for x in row))
            return new
        self.step = step
        self.rows = None if tel is None else tel.ticks
        self.graph = None
        self.graph_ticks = graph_ticks
        self.on_card = state.tick.is_cuda and graph_ticks > 0
        self._state = _map(torch.clone, state) if self.on_card \
            else state

    @property
    def state(self) -> DESState:
        return self._state

    @state.setter
    def state(self, new: DESState) -> None:
        if self.on_card:
            _map(lambda dst, src: dst.copy_(src), self._state, new)
        else:
            self._state = new

    def _capture(self) -> None:
        if self.rows is not None:              # the warm-up's row is not
            ptr = self.rows.ptr.clone()        # one of the run's
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm-up, result discarded
            self.step(_map(torch.clone, self._state))
        torch.cuda.current_stream().wait_stream(side)
        if self.rows is not None:
            self.rows.ptr.copy_(ptr)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            cur = self._state
            for _ in range(self.graph_ticks):
                cur = self.step(cur)
            self.state = cur

    def advance(self, count: int) -> None:
        if self.on_card:
            if self.graph is None:
                self._capture()
            replays, count = divmod(count, self.graph_ticks)
            for _ in range(replays):
                self.graph.replay()
        for _ in range(count):
            self.state = self.step(self._state)


def _run(cfg: DESConfig, nbr: torch.Tensor, s: DESState,
         sched: SpeedSchedule | None, chunk: int, batched: bool,
         dissat_fn=None, graph_ticks: int = _GRAPH_TICKS,
         tick_rows: int = 0):
    """Run a stack until every element drains (or reaches ``max_ticks``).

    Ticks run in chunks of ``refine_freq`` (``chunk`` without refinement),
    the first one cut to end on the cadence of element 0's tick; each
    element whose tick lands on the cadence, undrained, after a chunk in
    which it advanced, takes one refinement round with the live speeds of
    its last tick — where its tick-by-tick run refines inside that tick.
    Within a chunk the host reads whether anything is alive once every
    ``_SYNC_TICKS`` ticks, and stops ticking when nothing is.
    ``graph_ticks`` is the length of the card's CUDA graphs (0: eager).

    ``tick_rows > 0`` (telemetry, a lone run) also records its tick rows,
    in a device buffer of at least ``tick_rows`` rows, and its refinement
    rows, and returns ``(final state, tick rows, refinement rows, final
    counters)``, all read back in one transfer at the end (and the tick
    rows also whenever the next chunk could fill their buffer)."""
    freq = cfg.refine_freq
    period = freq if freq > 0 else max(1, min(chunk, cfg.max_ticks))
    speeds_of = _speeds_fn(cfg, s, sched)
    tel = _Telemetry(cfg, period, sched, s.tick, tick_rows) \
        if tick_rows > 0 else None
    ticks = _Ticks(cfg, nbr, s, speeds_of, graph_ticks, tel)
    tick0, alive = torch.stack([s.tick[0],
                                _alive(cfg, s).any().to(torch.int32)]
                               ).tolist()                       # host sync
    length = period - tick0 % period
    while alive:
        if tel is not None:
            tel.before_chunk()
        prev_tick = ticks.state.tick.clone()
        ran = 0
        while ran < length:
            ticks.advance(min(_SYNC_TICKS, length - ran))
            ran += min(_SYNC_TICKS, length - ran)
            alive = bool(_alive(cfg, ticks.state).any())        # host sync
            if not alive:
                break
        if freq > 0:
            s = ticks.state
            pred = ((s.tick % freq == 0) & ~s.done
                    & (s.tick != prev_tick)).tolist()           # host sync
            if any(pred):
                after = _refine_where(cfg, nbr, s, speeds_of(s.tick - 1),
                                      pred, batched, dissat_fn)
                if tel is not None:
                    tel.after_round(cfg, s, after)
                ticks.state = after
                alive = bool(_alive(cfg, ticks.state).any())
        length = period
    final = _map(torch.clone, ticks.state) if ticks.on_card \
        else ticks.state
    if tel is None:
        return final
    return (final, *tel.take(final))


def _device_inputs(adj, state: DESState, speed_schedule, lone: bool):
    """The topology as a (B, N, N) boolean and the schedule as a stacked
    one, on ``state``'s device; ``lone`` adds the batch axis of one."""
    dev = state.machine.device
    adj = adj if isinstance(adj, torch.Tensor) \
        else torch.as_tensor(np.asarray(adj, np.float32))
    nbr = adj.to(dev) > 0
    sched = None if speed_schedule is None else speed_schedule.to(dev)
    if lone:
        nbr = nbr[None]
        if sched is not None:
            sched = SpeedSchedule(sched.times[None], sched.speeds[None])
    return nbr, sched


def des_tick(cfg: DESConfig, adj, state: DESState,
             speed_schedule: SpeedSchedule | None = None,
             emit_tick=None, emit_refine=None,
             dissat_fn=None) -> DESState:
    """Advance the simulator by one wall-clock tick.

    ``speed_schedule`` (optional) supplies the per-machine speeds in
    effect this tick (speed-churn scenarios, :mod:`repro_torch.des.
    scenarios`); otherwise ``cfg.machine_speeds`` applies throughout.
    A tick on the refinement cadence refines (phase P6), which reads the
    cadence flag back to the host.  ``dissat_fn`` is
    :func:`~repro_torch.core.refine.refine`'s 9-argument seam for the
    refinement round (``None``: kernel 1 on the card).

    ``emit_tick`` / ``emit_refine`` (telemetry, e.g. a recorder's
    ``_on_tick_row`` / ``_on_refine_row``) are called on the host with the
    reference's rows as numpy scalars — ``emit_tick`` when the new tick is
    on the ``trace_stride`` cadence, ``emit_refine`` when the tick ran a
    refinement round — read back in one transfer after the tick.
    """
    _check_backend(cfg, dissat_fn)
    nbr, sched = _device_inputs(adj, state, speed_schedule, lone=True)
    s = stack_pytrees([state])
    speeds = _speeds_fn(cfg, s, sched)(s.tick)
    new = _tick(cfg, nbr, s, speeds)
    after, refined = new, False
    if cfg.refine_freq > 0:
        pred = ((new.tick % cfg.refine_freq == 0) & ~new.done).tolist()
        after = _refine_where(cfg, nbr, new, speeds, pred, False, dissat_fn)
        refined = pred[0]
    if emit_tick is not None or emit_refine is not None:
        row = _tick_row(cfg, s, after, speeds, _segments(sched, s.tick))
        host = read_back(*(x[0] for x in row + _refine_row(cfg, new, after)))
        if emit_tick is not None and int(host[0]) % cfg.trace_stride == 0:
            emit_tick(*host[:len(_TICK_ROW)])
        if emit_refine is not None and refined:
            emit_refine(*host[len(_TICK_ROW):])
    return unstack_pytree(after, 0)


def run_simulation(cfg: DESConfig, adj, state: DESState,
                   speed_schedule: SpeedSchedule | None = None,
                   recorder=None, dissat_fn=None) -> DESState:
    """Run ticks until all event lists drain (or ``max_ticks``).

    ``speed_schedule`` drives per-tick machine-speed churn (slowdown /
    failure / recovery scenarios, :mod:`repro_torch.des.scenarios`);
    ``None`` keeps ``cfg.machine_speeds`` (or uniform) throughout.  The
    run happens on ``state``'s device; ``adj`` is the (N, N) topology.
    Refinement rounds call :func:`~repro_torch.core.refine.refine` with
    ``dissat_fn`` (``None``: kernel 1 on the card, its twin on the CPU).

    ``recorder`` (a :class:`repro_torch.obs.Recorder`, DESIGN.md §14)
    opts into telemetry: one ``tick`` event per ``trace_stride`` ticks
    (GVT, cumulative counters, backlog CV, schedule segment, frozen
    LPs), one ``des_refine`` event per executed refinement round, and a
    closing ``run_end``.  The rows are written on the device inside the
    ticks (the card's CUDA graphs capture the writes) and read back at
    the end — and before a chunk that could fill their buffer of at
    least ``_TICK_ROWS`` rows.  ``recorder=None`` (default) runs exactly
    the recorder-free ticks.
    """
    return _run_lone(cfg, adj, state, speed_schedule, dissat_fn,
                     _GRAPH_TICKS, recorder)


def _run_lone(cfg: DESConfig, adj, state: DESState,
              speed_schedule: SpeedSchedule | None, dissat_fn,
              graph_ticks: int, recorder=None,
              tick_rows: int = _TICK_ROWS) -> DESState:
    """:func:`run_simulation` with the length of the card's CUDA graphs of
    ticks chosen — ``graph_ticks=0`` runs every tick eagerly, the
    reference that checks of the replayed ticks compare against — and,
    with a ``recorder``, the least capacity of the tick-row buffer."""
    def go(rows: int):
        _check_backend(cfg, dissat_fn)
        nbr, sched = _device_inputs(adj, state, speed_schedule, lone=True)
        return _run(cfg, nbr, stack_pytrees([state]), sched,
                    DEFAULT_BATCH_CHUNK, batched=False, dissat_fn=dissat_fn,
                    graph_ticks=graph_ticks, tick_rows=rows)

    if recorder is None:
        return unstack_pytree(go(0), 0)
    run = recorder.new_run(
        "des", n=cfg.num_lps, k=cfg.num_machines,
        refine_freq=cfg.refine_freq, backend=cfg.refine_backend,
        trace_stride=cfg.trace_stride, theta=cfg.refine_theta_scale > 0)
    recorder.begin_rows()
    with recorder.phase("des.run_simulation", run):
        final, ticks, refines, counters = go(tick_rows)
    for row in zip(*decode(ticks, _TICK_ROW)):
        recorder._on_tick_row(*row)
    for row in zip(*decode(refines, _REFINE_ROW)):
        recorder._on_refine_row(*row)
    recorder.record_des_rows(run)
    moves, tick, done, processed, rollbacks, refines_n, gvt = counters
    recorder.emit(
        "run_end", run, num_moves=int(moves), num_turns=int(tick),
        converged=bool(done), processed=int(processed),
        rollbacks=int(rollbacks), refines=int(refines_n), gvt=float(gvt))
    return unstack_pytree(final, 0)


# ---------------------------------------------------------------------------
# batched scenario fleets (DESIGN.md §12.4)
# ---------------------------------------------------------------------------

DEFAULT_BATCH_CHUNK = 256


def run_simulation_batch(cfg: DESConfig, adjs, states: DESState,
                         speed_schedules: SpeedSchedule | None = None,
                         chunk: int = DEFAULT_BATCH_CHUNK,
                         recorder=None, dissat_fn=None) -> DESState:
    """:func:`run_simulation` over a stack of B scenarios.

    ``adjs`` is ``(B, N, N)``, ``states`` a :class:`DESState` whose
    fields carry a leading batch axis (``stack_pytrees`` of B
    :func:`make_initial_state` results, all at tick 0), and
    ``speed_schedules`` is ``None`` or a stacked
    :class:`~repro_torch.des.scenarios.SpeedSchedule` (``(B, S)`` times /
    ``(B, S, K)`` speeds — :func:`~repro_torch.des.scenarios.
    stack_schedules`).  ``cfg`` is shared; everything data-like varies
    per element.  Every tick runs the whole stack; refinement rounds run
    through :func:`~repro_torch.core.batch.refine_batched` (kernel 3 on
    the card; ``dissat_fn`` its batched seam) on the elements whose
    cadence hits, so every element's final state — traces included — is
    bitwise the state its own :func:`run_simulation` reaches.  ``chunk``
    only applies when ``cfg.refine_freq == 0``.

    ``recorder`` opts into telemetry as the reference's does: per-tick
    streaming is left out for fleets, so the run emits one host-side
    ``element`` summary per scenario after the fleet drains (ticks,
    counters, time-averaged weighted-backlog CV over the trace rows)
    plus a closing ``run_end``.  ``recorder=None`` runs the identical
    fleet.
    """
    _check_backend(cfg, dissat_fn)
    nbr, sched = _device_inputs(adjs, states, speed_schedules, lone=False)
    if recorder is None:
        return _run(cfg, nbr, states, sched, chunk, batched=True,
                    dissat_fn=dissat_fn)
    from ..sweeps.metrics import time_averaged_cv  # sweeps imports des
    batch = int(nbr.shape[0])
    run = recorder.new_run(
        "des_batch", n=cfg.num_lps, k=cfg.num_machines, batch=batch,
        refine_freq=cfg.refine_freq, backend=cfg.refine_backend)
    with recorder.phase("des.run_simulation_batch", run):
        final = _run(cfg, nbr, states, sched, chunk, batched=True,
                     dissat_fn=dissat_fn)
        (ticks, processed, rollbacks, refines, moves, done, wload,
         ptrs) = read_back(final.tick, final.processed, final.rollbacks,
                           final.refines, final.moves, final.done,
                           final.trace_wload, final.trace_ptr)
    for i in range(batch):
        recorder.emit(
            "element", run, batch=i, ticks=int(ticks[i]),
            processed=int(processed[i]), rollbacks=int(rollbacks[i]),
            refines=int(refines[i]), moves=int(moves[i]),
            converged=bool(done[i]),
            wload_cv=time_averaged_cv(wload[i][:int(ptrs[i])]))
    recorder.emit("run_end", run, num_moves=int(moves.sum()),
                  num_turns=int(ticks.max()) if batch else 0,
                  converged=bool(done.all()))
    return final
