"""Public adapters around the kernels (port of ``repro.kernels.ops``).

Each adapter dispatches on where its tensors lie: CUDA tensors go to the
hand-written kernel (which raises on what it does not take — there is no
fallback), CPU tensors to the kernel's plain PyTorch twin.  The launch
counts live in :data:`repro_torch.kernels.dissatisfaction.launches`
(kernels 1–3), :data:`repro_torch.kernels.edge_block.launches` (kernels
4–5), :data:`repro_torch.kernels.decode_attention.launches` (kernel 6),
:data:`repro_torch.kernels.flash_attention.launches` (kernel 7) and
:data:`repro_torch.kernels.ssd_scan.launches` (kernel 8).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from . import ref
from .decode_attention import decode_attention_cuda, decode_attention_twin
from .dissatisfaction import (
    cost_matrix_cuda, cost_matrix_plain,
    dissatisfaction_from_aggregate_batched_cuda,
    dissatisfaction_from_aggregate_batched_plain,
    dissatisfaction_from_aggregate_cuda, dissatisfaction_from_aggregate_plain)
from .edge_block import (dissatisfaction_from_edges_cuda,
                         dissatisfaction_from_edges_plain,
                         sweep_candidates_from_edges_cuda,
                         sweep_candidates_from_edges_plain)
from .flash_attention import flash_attention_cuda, flash_attention_twin
from .ssd_scan import ssd_scan_cuda, ssd_scan_twin

if TYPE_CHECKING:
    from ..core.refine import DissatFn, SweepCandidateFn

# Declared asymptotic budgets for the kernel-reduction entry points,
# consumed by the complexity analyzers (``repro_torch.analysis``,
# DESIGN.md §18) and keyed by registered entry-point name.  The dense
# aggregate kernel (kernel 1) consumes the (N, N) adjacency's aggregate
# (dense budget); the edge kernel (kernel 4) streams the edge list in
# fixed chunks, so its outputs are O(N) and its work O(E * K) — the same
# contract as the plain sparse path it replaces.
KERNEL_COMPLEXITY = {
    "refine.kernel": {
        "mem": {"n": 2.0, "k": 1.0},
        "ops": {"n": 2.0, "k": 1.0},
    },
    "refine.sparse.edge_kernel": {
        "mem": {"n": 1.0, "e": 1.0, "k": 1.0},
        "ops": {"n": 1.0, "e": 1.0, "k": 1.0},
    },
}


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


def make_timed_dissat_fn(dissat_fn: DissatFn, recorder,
                         name: str = "kernels.dissat") -> DissatFn:
    """Wrap a ``dissat_fn`` with recorder phase timing (DESIGN.md §14.3).

    Every call is wall-clocked: ``recorder.phase(name)`` around the call
    and, when its output lies on the card, a ``torch.cuda.synchronize()``
    inside the span, so the span covers device execution, not just the
    launch.  That sync (one a call) is the price of timing each call, and
    this opt-in wrapper is the only place it is paid.  Follows the same
    9-argument convention as the wrapped callable, so it plugs into
    :func:`repro_torch.core.refine.refine(..., dissat_fn=...)
    <repro_torch.core.refine.refine>` anywhere the original does; the
    outputs are the wrapped function's, untouched.
    """
    def fn(*args, **kwargs):
        with recorder.phase(name):
            out = dissat_fn(*args, **kwargs)
            if any(isinstance(x, torch.Tensor) and _on_card(x)
                   for x in out):
                torch.cuda.synchronize()
        return out
    return fn


def dissatisfaction_from_aggregate_batched(aggregate, row_assignment,
                                           node_weights, loads, speeds, mu,
                                           total_weight,
                                           framework: str = "c", theta=None):
    """:func:`dissatisfaction_from_aggregate` over a fleet (DESIGN.md
    §12.3): every operand gains a leading B axis (``mu``, ``total_weight``
    (B,); ``theta`` ``None`` or (B, rows)).  CUDA tensors go to kernel 3,
    CPU tensors to its twin; element b is bitwise the unbatched call on
    element b."""
    fn = (dissatisfaction_from_aggregate_batched_cuda if _on_card(aggregate)
          else dissatisfaction_from_aggregate_batched_plain)
    return fn(aggregate, row_assignment, node_weights, loads, speeds, mu,
              framework, theta=theta, total_weight=total_weight)


def make_aggregate_dissat_fn_batched() -> DissatFn:
    """The 9-argument ``dissat_fn`` convention with a leading batch axis on
    every operand, on kernel 3 — what
    :func:`repro_torch.core.batch.refine_batched` uses when it is given no
    ``dissat_fn``."""
    def fn(aggregate, assignment, node_weights, loads, speeds, mu,
           framework, total_weight, theta=None):
        return dissatisfaction_from_aggregate_batched(
            aggregate, assignment, node_weights, loads, speeds, mu,
            total_weight, framework, theta=theta)
    return fn


def make_aggregate_dissat_fn_plain(batched: bool = False) -> DissatFn:
    """The 9-argument ``dissat_fn`` convention on the plain twin of kernel
    1 (``batched=False``, ``refine``'s seam) or of kernel 3
    (``batched=True``, ``refine_batched``'s) on any device: the path that
    checks of a kernel path compare against."""
    twin = (dissatisfaction_from_aggregate_batched_plain if batched
            else dissatisfaction_from_aggregate_plain)

    def fn(aggregate, assignment, node_weights, loads, speeds, mu,
           framework, total_weight, theta=None):
        return twin(aggregate, assignment, node_weights, loads, speeds, mu,
                    framework, theta=theta, total_weight=total_weight)
    return fn


def make_edge_dissat_fn(problem) -> DissatFn:
    """The ``dissat_fn`` convention on the edge-block kernel (kernel 4,
    DESIGN.md §13.3): the per-sweep reduction is recomputed straight from
    ``problem``'s edge list and the carried ``aggregate`` argument is
    ignored — the drift-free sparse oracle, O(E) per call.  ``problem``
    is a :class:`~repro_torch.core.sparse.SparseProblem`."""
    fn_edges = (dissatisfaction_from_edges_cuda
                if _on_card(problem.edge_weights)
                else dissatisfaction_from_edges_plain)

    def fn(aggregate, assignment, node_weights, loads, speeds, mu,
           framework, total_weight, theta=None):
        del aggregate   # recomputed from the edges
        return fn_edges(problem, assignment, node_weights, loads, speeds,
                        mu, framework, theta=theta,
                        total_weight=total_weight)
    return fn


def make_edge_sweep_fn(problem) -> SweepCandidateFn:
    """The :class:`~repro_torch.core.refine.SweepCandidateFn` convention
    on the edge-block sweep kernel (kernel 5, DESIGN.md §17.4): one pass
    over the edges per sweep yields the whole per-machine election
    ``(gains, picks, dests)``; the carried ``aggregate`` is ignored.
    For ``refine_sweeps(..., sweep_fn=...)`` with
    ``moves_per_machine=1``."""
    fn_edges = (sweep_candidates_from_edges_cuda
                if _on_card(problem.edge_weights)
                else sweep_candidates_from_edges_plain)

    def fn(aggregate, assignment, node_weights, loads, speeds, mu,
           framework, total_weight, theta=None):
        del aggregate   # recomputed from the edges
        return fn_edges(problem, assignment, node_weights, loads, speeds,
                        mu, framework, theta=theta,
                        total_weight=total_weight)
    return fn


def decode_attention(q, k, v, length) -> torch.Tensor:
    """GQA single-token decode attention: q (B, H, D) against the first
    ``length[b]`` rows of k, v (B, S, Hkv, D).  CUDA tensors go to kernel
    6, CPU tensors to its twin."""
    fn = decode_attention_cuda if _on_card(q) else decode_attention_twin
    return fn(q, k, v, length)


def flash_attention(q, k, v) -> torch.Tensor:
    """Causal GQA attention, q (B, S, H, D) and k, v (B, S, Hkv, D), with
    no S x S logits in device memory.  CUDA tensors go to kernel 7, CPU
    tensors to its twin."""
    fn = flash_attention_cuda if _on_card(q) else flash_attention_twin
    return fn(q, k, v)


def ssd_scan(x, dt, a, bm, cm, chunk: int, init_state=None):
    """Mamba2 SSD scan: x (B, L, H, P), dt (B, L, H), a (H,), bm and cm
    (B, L, N) -> (y (B, L, H, P) f32, final state (B, H, P, N) f32), from
    ``init_state`` (zeros when None).  CUDA tensors go to kernel 8, which
    walks its own chunk length (``chunk`` does not change the function),
    CPU tensors to its twin at ``chunk``."""
    if _on_card(x):
        return ssd_scan_cuda(x, dt, a, bm, cm, init_state)
    return ssd_scan_twin(x, dt, a, bm, cm, chunk, init_state)
