"""Bytes-exchanged accounting for the distributed protocol (DESIGN.md §9.3),
copied from ``repro.distributed.accounting``.

The protocol is deterministic, so the inter-machine payload of a run is an
exact function of what actually executed: number of turns/sweeps taken,
shard count S, machine count K, and the one-time ghost sync sized by the
sharding's boundary structure.  :func:`ledger_for_run` builds the ledger
from those measured quantities; the key property it exposes — and that
``benchmarks/distributed_bench.py`` verifies empirically across N = 256 →
4096 — is that **per-round payload contains no O(N) term**:

Incremental protocol (the default, DESIGN.md §10):

    sequential turn : S * 16 B                     (candidate all-gather)
    traced turn     : + S * 8 B                    (ΔC_0/ΔCt_0 exact-
                                                    potential deltas riding
                                                    on each candidate)
    §4.5 sweep      : S * (16K + 8K + 4) B         (K candidates + load &
                                                    sq-load partials + cut
                                                    partial per shard)
    one-time setup  : 8 * sum_s ghost_s  +  4K + 4 (ghost sync, loads, B)
    traced setup    : + S * 8                      (initial-potential
                                                    C_0/cut partial pair;
                                                    the loads are already
                                                    replicated by the 4K+4
                                                    setup allreduce)

Recompute protocol (``incremental=False`` drivers — pass
``incremental=False`` here too, the wire shapes differ):

    traced turn     : + S * (8 + 4K) B             (per-turn C_0/cut
                                                    partials + fresh O(K)
                                                    load partial)
    §4.5 sweep      : S * (16K + 4K + 8) B         (K candidates + load
                                                    partial + C_0/cut
                                                    partials per shard)

For contrast, :func:`naive_broadcast_bytes` gives the per-round cost of
the strawman protocol that re-broadcasts the full assignment vector —
O(N) per round — which the bench prints side by side.
"""
from __future__ import annotations

import dataclasses

from . import protocol
from .views import BoundaryStats


@dataclasses.dataclass(frozen=True)
class ExchangeLedger:
    """Inter-machine byte counters for one refinement run."""
    num_shards: int
    num_machines: int
    rounds: int                 # turns (sequential) or sweeps (§4.5)
    candidate_bytes: int        # per-candidate all-gathers, whole run
    trace_bytes: int            # potential partials (0 for untraced runs)
    ghost_sync_bytes: int       # one-time boundary-assignment sync
    setup_bytes: int            # one-time loads allreduce + total-B scalar
    fault_bytes: int = 0        # retry/duplicate re-sends + repair traffic
                                # (0 for fault-free runs; DESIGN.md §15.4)

    @property
    def per_round_bytes(self) -> float:
        """Steady-state payload per round — the O(K) quantity the paper
        claims is independent of N.  Fault traffic is excluded: retries
        are O(K) bursts and repair is amortized, reported separately."""
        if self.rounds == 0:
            return 0.0
        return (self.candidate_bytes + self.trace_bytes) / self.rounds

    @property
    def total_bytes(self) -> int:
        return (self.candidate_bytes + self.trace_bytes + self.fault_bytes
                + self.ghost_sync_bytes + self.setup_bytes)

    def summary(self) -> str:
        return (f"S={self.num_shards} K={self.num_machines} "
                f"rounds={self.rounds}: {self.per_round_bytes:.0f} B/round "
                f"steady-state, {self.ghost_sync_bytes} B ghost sync, "
                f"{self.total_bytes} B total")


def turn_payload_bytes(num_shards: int, num_machines: int,
                       traced: bool = False,
                       incremental: bool = True) -> int:
    """Wire bytes of ONE sequential turn (all machines combined).

    Incremental traced turns attach the two exact-potential-identity
    deltas to each candidate (8 B) — no per-turn partial reduction; the
    potentials are replicated state updated by the winner's deltas
    (DESIGN.md §10).  Recompute traced turns instead reduce per-shard
    C_0/cut partials plus a fresh O(K) load partial every turn."""
    bytes_ = num_shards * protocol.CANDIDATE_BYTES
    if traced:
        bytes_ += num_shards * protocol.TRACE_PARTIAL_BYTES
        if not incremental:
            bytes_ += num_shards * protocol.load_partial_bytes(num_machines)
    return bytes_


def sweep_payload_bytes(num_shards: int, num_machines: int,
                        incremental: bool = True) -> int:
    """Wire bytes of ONE §4.5 simultaneous sweep: K candidates per shard,
    plus — incrementally — the fresh O(K) load and sq-load partials and
    the f32 cut partial for the closed-form potentials (simultaneous
    moves are not unilateral, so the identity deltas do not apply).  The
    recompute sweep ships one load partial and the 8-byte C_0/cut
    partial pair per shard instead."""
    per_shard = num_machines * protocol.CANDIDATE_BYTES
    if incremental:
        per_shard += 2 * protocol.load_partial_bytes(num_machines) + 4
    else:
        per_shard += (protocol.load_partial_bytes(num_machines)
                      + protocol.TRACE_PARTIAL_BYTES)
    return num_shards * per_shard


def ghost_sync_bytes(stats: BoundaryStats) -> int:
    """One-time boundary sync: each shard receives (node id, assignment)
    pairs for its ghost nodes — 8 bytes per ghost."""
    return 8 * stats.total_ghosts


def setup_bytes(num_machines: int) -> int:
    """One-time replicated aggregates: the O(K) load vector + scalar B."""
    return 4 * num_machines + 4


def init_potential_bytes(num_shards: int, num_machines: int) -> int:
    """One-time traced-run setup: the initial-potential partial reduction
    (C_0 partial + cut partial per shard).

    No load partial rides along: the traced driver seeds the reduction
    with the loads the 4K+4 setup allreduce already replicated
    (``fresh_loads=state0.loads`` in ``runtime._vmap_potentials``), so
    charging an O(K) block per shard here would over-count — the
    measured-wire cross-check of DESIGN.md §14.5 is what caught the
    discrepancy (``num_machines`` stays in the signature for call-site
    symmetry with the other formulas)."""
    del num_machines
    return num_shards * protocol.TRACE_PARTIAL_BYTES


def ledger_for_run(stats: BoundaryStats, num_machines: int, rounds: int,
                   *, traced: bool = False, simultaneous: bool = False,
                   incremental: bool = True,
                   fault_bytes: int = 0) -> ExchangeLedger:
    """Ledger for an executed run (``rounds`` = its measured turn count).

    ``incremental`` must match the driver flag the run used — the traced
    and sweep wire shapes differ between the two protocols (see the
    module docstring).  ``fault_bytes`` is the degraded-mode extra
    traffic (candidate re-sends + repair payloads) of a fault-injected
    run, computed from its :class:`repro.distributed.faults.FaultPlan`
    via ``faults.plan_extra_bytes`` — the drivers accumulate the same
    per-round sum on device, so :func:`reconcile` stays byte-exact."""
    s = stats.num_shards
    setup = setup_bytes(num_machines)
    if simultaneous:
        per_round = sweep_payload_bytes(s, num_machines,
                                        incremental=incremental)
        trace = 0
    else:
        per_round = s * protocol.CANDIDATE_BYTES
        trace = rounds * (turn_payload_bytes(s, num_machines, traced,
                                             incremental=incremental)
                          - per_round)
        if traced and incremental:
            setup += init_potential_bytes(s, num_machines)
    return ExchangeLedger(
        num_shards=s,
        num_machines=num_machines,
        rounds=rounds,
        candidate_bytes=rounds * per_round,
        trace_bytes=trace,
        ghost_sync_bytes=ghost_sync_bytes(stats),
        setup_bytes=setup,
        fault_bytes=int(fault_bytes),
    )


def naive_broadcast_bytes(num_nodes: int, num_shards: int) -> int:
    """Per-round cost of the O(N) strawman: every shard re-receives the
    full int32 assignment vector each round."""
    return 4 * num_nodes * num_shards


@dataclasses.dataclass(frozen=True)
class WireCheck:
    """Measured-vs-analytic reconciliation of one run's exchange bytes.

    ``measured_*`` comes from a driver's ``measure_wire=True`` counters
    (``runtime.WireMeasurement`` — byte sizes of the actual exchanged
    device buffers times the rounds the run executed); ``predicted_*``
    from :func:`ledger_for_run`.  The payload comparison covers the
    per-round candidate + trace traffic; setup covers the one-time
    loads/total-B allreduce plus, for incremental traced runs, the
    initial-potential partials.  The ghost sync is excluded on both
    sides: it is a property of the *sharding's boundary structure*, not
    of anything the emulated drivers exchange at runtime, so it stays
    analytic-only (DESIGN.md §14.5).
    """
    rounds: int
    measured_payload: int
    predicted_payload: int
    measured_setup: int
    predicted_setup: int

    @property
    def ok(self) -> bool:
        return (self.measured_payload == self.predicted_payload
                and self.measured_setup == self.predicted_setup)

    def summary(self) -> str:
        verdict = "OK" if self.ok else "MISMATCH"
        return (f"wire [{verdict}] rounds={self.rounds}: payload "
                f"{self.measured_payload} B measured vs "
                f"{self.predicted_payload} B predicted, setup "
                f"{self.measured_setup} vs {self.predicted_setup} B")


def reconcile(ledger: ExchangeLedger, measurement) -> WireCheck:
    """Cross-check a ``runtime.WireMeasurement`` against its ledger.

    Build the ledger with ``rounds=int(measurement.rounds)`` (both sides
    must describe the same executed run) and matching ``traced`` /
    ``simultaneous`` / ``incremental`` flags — the O(K)-wire claim then
    becomes the runtime assertion ``reconcile(...).ok``.
    """
    rounds = int(measurement.rounds)
    if rounds != ledger.rounds:
        raise ValueError(
            f"measurement covers {rounds} rounds but the ledger was built "
            f"for {ledger.rounds}; pass rounds=int(measurement.rounds) to "
            "ledger_for_run")
    return WireCheck(
        rounds=rounds,
        measured_payload=int(measurement.payload_bytes),
        predicted_payload=(ledger.candidate_bytes + ledger.trace_bytes
                          + ledger.fault_bytes),
        measured_setup=int(measurement.setup_bytes),
        predicted_setup=ledger.setup_bytes,
    )
