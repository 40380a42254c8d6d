"""Public adapters around the kernels (port of ``repro.kernels.ops``).

Each adapter dispatches on where its tensors lie: CUDA tensors go to the
hand-written kernel (which raises on what it does not take — there is no
fallback), CPU tensors to the kernel's plain PyTorch twin.  The launch
counts live in :data:`repro_torch.kernels.dissatisfaction.launches`.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from . import ref
from .dissatisfaction import (cost_matrix_cuda, cost_matrix_plain,
                              dissatisfaction_from_aggregate_cuda,
                              dissatisfaction_from_aggregate_plain)

if TYPE_CHECKING:
    from ..core.refine import DissatFn


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def cost_matrix(adjacency, assignment, node_weights, loads, speeds, mu,
                framework: str = "c", *, row_assignment=None,
                total_weight=None) -> torch.Tensor:
    """(rows, K) node-cost matrix via the cost-matrix kernel (or its plain
    twin on the CPU).  ``adjacency`` may be a (rows, N) row block; pass
    ``row_assignment`` and the global ``total_weight`` then."""
    fn = cost_matrix_cuda if _on_card(adjacency) else cost_matrix_plain
    return fn(adjacency, assignment, node_weights, loads, speeds, mu,
              framework, row_assignment=row_assignment,
              total_weight=total_weight)


def cost_matrix_reference(adjacency, assignment, node_weights, loads,
                          speeds, mu, framework: str = "c") -> torch.Tensor:
    return ref.cost_matrix_ref(adjacency, assignment, node_weights, loads,
                               speeds, mu, framework)


def make_core_cost_matrix_fn():
    """Adapter with the (problem, state, framework) signature expected by
    ``repro_torch.core.refine.refine(..., cost_matrix_fn=...)``, so the
    recompute-path loop runs on the cost-matrix kernel."""
    def fn(problem, state, framework):
        return cost_matrix(problem.adjacency, state.assignment,
                           problem.node_weights, state.loads, problem.speeds,
                           problem.mu, framework)
    return fn


def dissatisfaction_from_aggregate(aggregate, row_assignment, node_weights,
                                   loads, speeds, mu, total_weight,
                                   framework: str = "c", theta=None):
    """(dissat, best_machine) from a carried aggregate via the fused
    kernel — the incremental refinement hot path, with no (N, K) cost
    matrix in device memory.  ``theta`` (rows,) is subtracted inside the
    fused reduction (DESIGN.md §11)."""
    fn = (dissatisfaction_from_aggregate_cuda if _on_card(aggregate)
          else dissatisfaction_from_aggregate_plain)
    return fn(aggregate, row_assignment, node_weights, loads, speeds, mu,
              framework, theta=theta, total_weight=total_weight)


def make_aggregate_dissat_fn() -> DissatFn:
    """THE 9-argument ``dissat_fn`` convention (see
    :mod:`repro_torch.core.refine`) on the fused kernel; this is what
    ``refine`` uses when it is given no ``dissat_fn``."""
    def fn(aggregate, assignment, node_weights, loads, speeds, mu,
           framework, total_weight, theta=None):
        return dissatisfaction_from_aggregate(
            aggregate, assignment, node_weights, loads, speeds, mu,
            total_weight, framework, theta=theta)
    return fn
