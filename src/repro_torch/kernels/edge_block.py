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
  epilogue, then the per-machine election (largest gain, lowest node on
  ties, its best machine): each block's firsts go into running integer
  maxima of (gain, node) keys, which the last block to finish (an integer
  ticket) reads — one launch a call, where the reference combines its
  tiles' partials outside its ``pallas_call``.

A block of :data:`ROWS` rows stages its edge range through shared memory
in chunks of :data:`CHUNK` edges, gathers the receivers' machines
edge-parallel, and each thread walks its row's edges of every chunk in
order into K accumulators (registers for :data:`SPECIALISED_K`).  Each
row's K slots so sum its edges in ascending edge order from 0, the order
of the reference's ``segment_sum``, and the epilogue is kernel 1's
(``csrc/reduce_dissat.cuh``), so kernel 4 is bitwise kernel 1 on the
aggregate of :func:`repro_torch.core.costs.adjacency_aggregate_sparse`.
The twins below compute that aggregate window by window and run
:func:`~repro_torch.kernels.dissatisfaction.reduce_dissat_tile_plain`.

A wrapper launches its kernel only for CUDA tensors and raises on what it
does not take; the twin is for tensors on the CPU.  Each kernel launch
adds one to :data:`launches`.  Both wrappers take kernels 1 and 3's lean
launch path: checks of one comparison each (:func:`check_edge_operands`,
which runs on CPU tensors too), device scalars passed as they are, entry
points bound once, the raw current stream, no sync.  Kernel 5 keeps a
per-device buffer of zeros for its ticket and running maxima
(:func:`_ticket`) that every launch leaves at zero; calls on one device
must not run concurrently on two streams.
"""
from __future__ import annotations

import torch

from ..core.costs import adjacency_aggregate_sparse
from .dissatisfaction import (MAX_K, _check, _entry_point, _framework_code,
                              _raise_on, _scalar, _stream,
                              reduce_dissat_tile_plain)

ROWS = 128       # rows a block (kRows in csrc/edge_block.cu)
CHUNK = 1024     # edges a staged chunk holds (kChunk)
# K with a compile-time instance (the cases of launch_k); every other K up
# to MAX_K takes the runtime-K instance
SPECIALISED_K = (8, 16)

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

_F32, _I32 = torch.float32, torch.int32


def check_edge_operands(sp, assignment, node_weights, loads, speeds,
                        theta=None, *, device):
    """The operand checks of kernels 4 and 5, on any device (so they run
    on the CPU too): raises ValueError on what the kernels do not take and
    returns ``(N, E, K)``."""
    n, e, k = sp.num_nodes, sp.num_edges, loads.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}; got K={k}")
    if n < 1:
        raise ValueError("the kernel needs at least one node")
    _check("row_start", sp.row_start, _I32, (n,), device)
    _check("receivers", sp.receivers, _I32, (e,), device)
    _check("edge_weights", sp.edge_weights, _F32, (e,), device)
    _check("assignment", assignment, _I32, (n,), device)
    _check("node_weights", node_weights, _F32, (n,), device)
    _check("loads", loads, _F32, (k,), device)
    _check("speeds", speeds, _F32, (k,), device)
    if theta is not None:
        _check("theta", theta, _F32, (n,), device)
    return n, e, k


# device index -> kernel 5's ticket and running maxima (:func:`_ticket`)
_tickets: dict = {}


def _ticket(device) -> torch.Tensor:
    """Kernel 5's ticket, a pad, then MAX_K uint64 maxima, as int32 zeros
    on ``device``, kept across calls: each launch leaves them at zero."""
    buf = _tickets.get(device.index)
    if buf is None:
        buf = _tickets[device.index] = torch.zeros(2 + 2 * MAX_K, dtype=_I32,
                                                   device=device)
    return buf


def _inputs(sp, assignment, node_weights, loads, speeds, mu, theta,
            total_weight, device):
    """The ten input pointers both entry points take first, and the two
    device scalars, which the caller holds until the launch is enqueued."""
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    mu_t = _scalar(mu, device)
    tb_t = _scalar(total_weight, device)
    ptrs = (sp.row_start.data_ptr(), sp.receivers.data_ptr(),
            sp.edge_weights.data_ptr(), assignment.data_ptr(),
            node_weights.data_ptr(),
            None if theta is None else theta.data_ptr(), loads.data_ptr(),
            speeds.data_ptr(), mu_t.data_ptr(), tb_t.data_ptr())
    return ptrs, (mu_t, tb_t)


def sweep_candidates_args(inputs, n: int, e: int, k: int, code: int,
                          stream, device, *, rows: int = ROWS):
    """Kernel 5's C arguments after ``inputs`` (the ten input pointers of
    :func:`_inputs`) and the ``(gains, picks, dests)`` (K,) views it
    writes: one int32 buffer holds the blocks' partials (gains and dests,
    at most one block a tile of ``rows`` rows), then the three outputs;
    the ticket is :func:`_ticket`'s."""
    parts = 2 * k * -(-n // rows)
    buf = torch.empty(parts + 3 * k, dtype=_I32, device=device)
    out = buf.data_ptr() + 4 * parts
    args = (*inputs, out, out + 4 * k, out + 8 * k, buf.data_ptr(),
            _ticket(device).data_ptr(), n, e, k, code, stream)
    return args, (buf[parts:parts + k].view(_F32),
                  buf[parts + k:parts + 2 * k], buf[parts + 2 * k:])


def dissatisfaction_from_edges_cuda(sp, assignment, node_weights, loads,
                                    speeds, mu, framework: str = "c", *,
                                    theta=None, total_weight=None):
    """Kernel 4 on the card: ``(dissat (N,) f32, best (N,) i32)`` from the
    edge list of the :class:`~repro_torch.core.sparse.SparseProblem`
    ``sp`` and the (N,) int32 ``assignment``, net of ``theta``.  ``mu``
    and ``total_weight`` may be device scalars (read by the kernel, no
    host round trip)."""
    if not assignment.is_cuda:
        raise ValueError("dissatisfaction_from_edges_cuda needs CUDA "
                         "tensors")
    device = assignment.device
    n, e, k = check_edge_operands(sp, assignment, node_weights, loads,
                                  speeds, theta, device=device)
    code = _framework_code(framework)
    ptrs, _scalars = _inputs(sp, assignment, node_weights, loads, speeds,
                             mu, theta, total_weight, device)
    dissat = torch.empty_like(node_weights)
    best = torch.empty_like(assignment)
    status = _entry_point("dissat_from_edges", "edge_block")(
        *ptrs, dissat.data_ptr(), best.data_ptr(), n, e, k, code,
        _stream(device))
    _raise_on(status, "dissat_from_edges")
    launches["dissat_from_edges"] += 1
    return dissat, best


def sweep_candidates_from_edges_cuda(sp, assignment, node_weights, loads,
                                     speeds, mu, framework: str = "c", *,
                                     theta=None, total_weight=None):
    """Kernel 5 on the card, one launch: ``(gains (K,) f32, picks (K,)
    i32, dests (K,) i32)`` — each machine's best net dissatisfaction among
    its owned nodes (``NEG_BIG`` when it owns none), the lowest node
    reaching it, and that node's best machine, as
    :func:`sweep_candidates_args` lays them out."""
    if not assignment.is_cuda:
        raise ValueError("sweep_candidates_from_edges_cuda needs CUDA "
                         "tensors")
    device = assignment.device
    n, e, k = check_edge_operands(sp, assignment, node_weights, loads,
                                  speeds, theta, device=device)
    code = _framework_code(framework)
    ptrs, _scalars = _inputs(sp, assignment, node_weights, loads, speeds,
                             mu, theta, total_weight, device)
    args, outs = sweep_candidates_args(ptrs, n, e, k, code, _stream(device),
                                       device)
    status = _entry_point("sweep_candidates_from_edges", "edge_block")(*args)
    _raise_on(status, "sweep_candidates_from_edges")
    launches["sweep_candidates_from_edges"] += 1
    return outs
