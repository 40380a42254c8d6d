"""Checkpoint/heal for the carried aggregate state (DESIGN.md §15.3),
PyTorch port of ``repro.core.checkpoint``.

A :class:`Checkpoint` is a snapshot of the carry.  The carry is never
updated in place (:mod:`repro_torch.core.aggregate`), so the snapshot
aliases the state's tensors and copies nothing.  :func:`heal` is the
recovery step of ``refine(..., repair_every=M)``:

1. **Rollback** — if any float field of the live carry is non-finite, the
   whole carry is replaced by the last checkpoint (a NaN poisons every
   reduction that reads it, so no column-wise patch is sound).
2. **Column repair** — :func:`repro_torch.core.aggregate.repair_columns`
   patches only the aggregate columns, load entries and potentials that
   deviate beyond ``tol`` from a rebuild.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import aggregate as agg_mod
from .aggregate import AggregateState

# the repo-wide drift budget
DEFAULT_REPAIR_TOL = 1e-3


class Checkpoint(NamedTuple):
    """A known-good carry snapshot plus the turn it was taken at."""
    state: AggregateState
    turn: torch.Tensor            # () int32


def take(agg: AggregateState, turn) -> Checkpoint:
    """Snapshot the carry (an alias: states are immutable)."""
    if isinstance(turn, torch.Tensor):
        turn = turn.to(device=agg.loads.device, dtype=torch.int32)
    else:
        turn = torch.full((), int(turn), dtype=torch.int32,
                          device=agg.loads.device)
    return Checkpoint(state=agg, turn=turn)


def restore(ckpt: Checkpoint) -> AggregateState:
    """The checkpointed carry (symmetry helper for :func:`take`)."""
    return ckpt.state


def is_healthy(agg: AggregateState) -> torch.Tensor:
    """True iff every float field of the carry is finite."""
    ok = torch.ones((), dtype=torch.bool, device=agg.loads.device)
    for leaf in agg:
        if leaf.dtype.is_floating_point:
            ok = ok & torch.all(torch.isfinite(leaf))
    return ok


def heal(problem, agg: AggregateState, ckpt: Checkpoint,
         tol: float = DEFAULT_REPAIR_TOL):
    """Rollback-if-poisoned, then column repair.

    Returns ``(repaired, observed, cols, rolled_back)``: the healed carry,
    the max pre-repair deviation (inf when the live carry was rolled back),
    the number of aggregate columns patched, and whether it rolled back.
    """
    healthy = is_healthy(agg)
    base = AggregateState(*(torch.where(healthy, live, saved)
                            for live, saved in zip(agg, ckpt.state)))
    repaired, observed, cols = agg_mod.repair_columns(problem, base, tol)
    observed = torch.where(healthy, observed, float("inf"))
    return repaired, observed, cols, ~healthy
