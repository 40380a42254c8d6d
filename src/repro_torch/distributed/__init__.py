"""``repro_torch.distributed`` — sharded multi-machine refinement runtime
(PyTorch port of ``repro.distributed``).

Executes the round-robin refinement game of
:mod:`repro_torch.core.refine` as a distributed program (DESIGN.md §9):
node state lives sharded across machines, every machine computes candidate
moves from its local shard plus a replicated O(K) load vector, and
machines exchange only O(K) aggregate messages per turn — the paper's
central scalability claim.

Modules:
  * :mod:`~repro_torch.distributed.views`      — per-machine local views
    and ghost/boundary summaries.
  * :mod:`~repro_torch.distributed.protocol`   — the O(K) message types,
    shard-local candidates, deterministic election, delta application.
  * :mod:`~repro_torch.distributed.runtime`    — the drivers: emulated
    (every shard on one device, one kernel-3 launch a turn), and one
    shard per rank of a ``torch.distributed`` group; sequential-turn and
    §4.5 simultaneous-sweep modes.
  * :mod:`~repro_torch.distributed.accounting` — bytes-exchanged ledgers
    proving the O(K + boundary) bound empirically.
  * :mod:`~repro_torch.distributed.faults`     — seeded fault injection
    (FaultPlan), degraded-mode policy (DegradedMode) and the
    recover-or-raise report types (DESIGN.md §15).
"""
from .accounting import ExchangeLedger, WireCheck, ledger_for_run, reconcile
from .faults import (DeadShardError, DegradedMode, FaultPlan, FaultReport,
                     FaultToleranceError, RecoveryFailedError,
                     make_fault_plan, zero_fault_plan)
from .runtime import (WireMeasurement, refine_distributed,
                      refine_distributed_shard_map,
                      refine_distributed_simultaneous,
                      refine_distributed_traced, shard_problem)
from .views import ShardViews, boundary_stats, build_views

__all__ = [
    "DeadShardError",
    "DegradedMode",
    "ExchangeLedger",
    "FaultPlan",
    "FaultReport",
    "FaultToleranceError",
    "RecoveryFailedError",
    "ShardViews",
    "WireCheck",
    "WireMeasurement",
    "boundary_stats",
    "build_views",
    "ledger_for_run",
    "make_fault_plan",
    "zero_fault_plan",
    "reconcile",
    "refine_distributed",
    "refine_distributed_shard_map",
    "refine_distributed_simultaneous",
    "refine_distributed_traced",
    "shard_problem",
]
