"""Edge-block kernels (DESIGN.md §13.3, §17.4): the sparse runtime's
per-sweep reductions straight from the edge list, with their plain
PyTorch twins.

Two kernels, both in ``csrc/edge_block.cu`` and built by
:mod:`repro_torch.kernels._build`:

* ``dissat_from_edges`` (kernel 4) — replaces the TPU kernel
  ``repro.kernels.edge_block.dissatisfaction_from_edges_pallas``: Eq.-4
  ``(dissat, best)`` for every node from the CSR edge list, net of θ,
  with no (N, K) aggregate in device memory.
* ``sweep_candidates_from_edges`` (kernel 5) — replaces
  ``sweep_candidates_from_edges_pallas``: the same accumulation and
  epilogue, then each block's per-machine election (largest gain, lowest
  node on ties, its best machine); the (T, K) partials combine here by a
  first maximum over blocks — the globally lowest node on ties — as the
  reference combines outside its ``pallas_call``.

Each row's K slots sum its edges in ascending edge order from 0, the
order of the reference's ``segment_sum``, and the epilogue is kernel 1's
(``csrc/reduce_dissat.cuh``), so kernel 4 is bitwise kernel 1 on the
aggregate of :func:`repro_torch.core.costs.adjacency_aggregate_sparse`.
The twins below compute that aggregate window by window and run
:func:`~repro_torch.kernels.dissatisfaction.reduce_dissat_tile_plain`.

A wrapper launches its kernel only for CUDA tensors and raises on what it
does not take; the twin is for tensors on the CPU.  Each kernel launch
adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.costs import adjacency_aggregate_sparse
from .dissatisfaction import (MAX_K, _check, _framework_code, _ptr,
                              _raise_on, _scalar, reduce_dissat_tile_plain)

# kernel name -> launches since the last reset_launches()
launches = {"dissat_from_edges": 0, "sweep_candidates_from_edges": 0}

NEG_BIG = -3.0e38    # the reference's -_BIG: the gain of a machine owning nothing


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def dissatisfaction_from_edges_plain(sp, assignment, node_weights, loads,
                                     speeds, mu, framework: str = "c", *,
                                     theta=None, total_weight=None):
    """Plain twin of :func:`dissatisfaction_from_edges_cuda`: the
    window-summed aggregate, then the shared epilogue."""
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    aggregate = adjacency_aggregate_sparse(sp, assignment)
    return reduce_dissat_tile_plain(
        aggregate, assignment, node_weights, theta, loads, speeds, mu,
        total_weight, framework=framework)


def elect(dissat, best, assignment, k: int):
    """The per-machine sweep election from per-node ``(dissat, best)``:
    each machine's largest net dissatisfaction among its owned nodes
    (``NEG_BIG`` when it owns none), the first node reaching it, and that
    node's best machine.  Returns ``(gains, picks, dests)``, (K,) each."""
    kidx = torch.arange(k, device=dissat.device)
    owned = assignment.long()[None, :] == kidx[:, None]       # (K, N)
    masked = torch.where(owned, dissat[None, :], NEG_BIG)
    gains = torch.max(masked, dim=1).values
    picks = torch.argmax(masked, dim=1)                        # first max
    return gains, picks.to(torch.int32), best.index_select(0, picks)


def sweep_candidates_from_edges_plain(sp, assignment, node_weights, loads,
                                      speeds, mu, framework: str = "c", *,
                                      theta=None, total_weight=None):
    """Plain twin of :func:`sweep_candidates_from_edges_cuda`."""
    dissat, best = dissatisfaction_from_edges_plain(
        sp, assignment, node_weights, loads, speeds, mu, framework,
        theta=theta, total_weight=total_weight)
    return elect(dissat, best, assignment, loads.shape[0])


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _edge_operands(sp, assignment, node_weights, loads, speeds, mu, theta,
                   total_weight, who: str):
    """Check every operand of an edge-block kernel; return the C
    arguments they share — the (row_start, receivers, weights,
    assignment, b, theta, loads, speeds, mu, total_b) pointers and
    (n, e, k) — and the two device scalars, which the caller holds until
    the launch is enqueued."""
    device = assignment.device
    if device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors")
    n, e, k = sp.num_nodes, sp.num_edges, loads.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}; got K={k}")
    if n < 1:
        raise ValueError("the kernel needs at least one node")
    _check("row_start", sp.row_start, torch.int32, (n,), device)
    _check("receivers", sp.receivers, torch.int32, (e,), device)
    _check("edge_weights", sp.edge_weights, torch.float32, (e,), device)
    _check("assignment", assignment, torch.int32, (n,), device)
    _check("node_weights", node_weights, torch.float32, (n,), device)
    _check("loads", loads, torch.float32, (k,), device)
    _check("speeds", speeds, torch.float32, (k,), device)
    if theta is not None:
        _check("theta", theta, torch.float32, (n,), device)
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    mu_t = _scalar(mu, device)
    tb_t = _scalar(total_weight, device)
    ptrs = [_ptr(x) for x in (sp.row_start, sp.receivers, sp.edge_weights,
                              assignment, node_weights, theta, loads, speeds,
                              mu_t, tb_t)]
    return ptrs, (n, e, k), (mu_t, tb_t)


def dissatisfaction_from_edges_cuda(sp, assignment, node_weights, loads,
                                    speeds, mu, framework: str = "c", *,
                                    theta=None, total_weight=None):
    """Kernel 4 on the card: ``(dissat (N,) f32, best (N,) i32)`` from the
    edge list of the :class:`~repro_torch.core.sparse.SparseProblem`
    ``sp`` and the (N,) int32 ``assignment``, net of ``theta``."""
    from . import _build
    ptrs, (n, e, k), _scalars = _edge_operands(
        sp, assignment, node_weights, loads, speeds, mu, theta,
        total_weight, "dissatisfaction_from_edges_cuda")
    device = assignment.device
    dissat = torch.empty((n,), dtype=torch.float32, device=device)
    best = torch.empty((n,), dtype=torch.int32, device=device)
    lib = _build.library("edge_block")
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.dissat_from_edges(*ptrs, _ptr(dissat), _ptr(best), n, e, k,
                                   _framework_code(framework),
                                   ctypes.c_void_p(stream))
    _raise_on(status, "dissat_from_edges")
    launches["dissat_from_edges"] += 1
    return dissat, best


def sweep_candidates_from_edges_cuda(sp, assignment, node_weights, loads,
                                     speeds, mu, framework: str = "c", *,
                                     theta=None, total_weight=None):
    """Kernel 5 on the card: ``(gains (K,) f32, picks (K,) i32, dests (K,)
    i32)`` — each machine's best net dissatisfaction among its owned
    nodes (``NEG_BIG`` when it owns none), the lowest node reaching it,
    and that node's best machine."""
    from . import _build
    ptrs, (n, e, k), _scalars = _edge_operands(
        sp, assignment, node_weights, loads, speeds, mu, theta,
        total_weight, "sweep_candidates_from_edges_cuda")
    device = assignment.device
    lib = _build.library("edge_block")
    rows = lib.edge_block_rows()
    tiles = -(-n // rows)
    gain_t = torch.empty((tiles, k), dtype=torch.float32, device=device)
    node_t = torch.empty((tiles, k), dtype=torch.int32, device=device)
    dest_t = torch.empty((tiles, k), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.sweep_candidates_from_edges(
        *ptrs, _ptr(gain_t), _ptr(node_t), _ptr(dest_t), n, e, k,
        _framework_code(framework), ctypes.c_void_p(stream))
    _raise_on(status, "sweep_candidates_from_edges")
    launches["sweep_candidates_from_edges"] += 1
    # first maximum over blocks: the lowest winning block holds the
    # globally lowest winning node
    win = torch.argmax(gain_t, dim=0, keepdim=True)            # (1, K)
    return (torch.max(gain_t, dim=0).values,
            node_t.gather(0, win)[0], dest_t.gather(0, win)[0])
