"""Hand-written CUDA kernels for the refinement hot spot, with their plain
PyTorch twins (DESIGN.md §3.2, §10).

Three kernels, all in ``csrc/dissatisfaction.cu`` and built by
:mod:`repro_torch.kernels._build`:

* ``dissat_from_aggregate`` — replaces the TPU kernel
  ``repro.kernels.dissatisfaction.dissatisfaction_from_aggregate_pallas``.
  The incremental path carries the (rows, K) aggregate; one thread per
  row reads its A row, assembles the K costs in registers and writes only
  ``(dissat, best)``.  The (rows, K) cost matrix never reaches device
  memory.
* ``dissat_from_aggregate_batched`` — replaces
  ``dissatisfaction_from_aggregate_batched_pallas``: kernel 1 over a
  (B, rows, K) fleet stack on a (row blocks, B) grid, each element
  reading its own machine table and scalars and ending in the same
  epilogue, so each element is bitwise kernel 1's (DESIGN.md §12.3).
* ``cost_matrix`` — replaces ``cost_matrix_pallas``: each warp streams one
  adjacency row (rectangular row blocks allowed), accumulates
  ``acc[r_j] += c_ij`` in lane-private shared-memory slots in a fixed
  order, folds the lanes in a fixed order, then runs the same cost
  assembly and writes the (rows, K) cost block.

All three assemble costs in the op order of the reference epilogue
``reduce_dissat_tile``: the degree is summed k ascending, the kernels are
compiled with ``-fmad=false`` so no multiply-add is contracted, and ties
break toward the lowest machine index (DESIGN.md §7).  The plain twins
below repeat that arithmetic with separate PyTorch ops: the CPU tests use
them, and the card's check holds each kernel against its twin.

A wrapper launches its kernel only for CUDA tensors and raises on what the
kernel does not take; the plain twin is for tensors on the CPU.  Each
kernel launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.costs import per_element, row_sum

MAX_K = 128      # machines the kernels take (shared-memory slots per row)
MAX_BATCH = 65535   # fleet elements kernel 3 takes (its grid's y extent)

# kernel name -> launches since the last reset_launches()
launches = {"dissat_from_aggregate": 0, "cost_matrix": 0,
            "dissat_from_aggregate_batched": 0}

_FRAMEWORK_CODE = {"c": 0, "ct": 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _assemble_cost_plain(aggregate, r_rows, b_rows, loads, speeds, mu,
                         total_b, framework: str):
    """The reference epilogue's cost assembly, op for op
    (``repro.kernels.dissatisfaction.reduce_dissat_tile``).  A leading
    batch axis on every operand (``mu`` and ``total_b`` (B,)) assembles
    each element with the same ops."""
    k = aggregate.shape[-1]
    kidx = torch.arange(k, device=aggregate.device)
    b = b_rows.to(torch.float32)[..., None]                    # (rows, 1)
    own = (r_rows.long()[..., None] == kidx).to(torch.float32)
    loads = loads[..., None, :]                                # (1, K)
    inv_w = 1.0 / speeds[..., None, :]
    degree = row_sum(aggregate)
    others = loads - b * own
    cut_term = 0.5 * per_element(mu, 2) * (degree - aggregate)
    if framework == "c":
        return (b * inv_w) * others + cut_term
    if framework == "ct":
        return (b * b) * inv_w * inv_w \
            + 2.0 * b * inv_w * inv_w * others \
            - 2.0 * b * inv_w * per_element(total_b, 2) + cut_term
    raise ValueError(f"unknown framework {framework!r}")


def reduce_dissat_tile_plain(aggregate, r_rows, b_rows, theta_rows, loads,
                             speeds, mu, total_b, *, framework: str):
    """The fused cost assembly + Eq.-4 reduction over a (rows, K) block:
    net-of-theta dissatisfaction (DESIGN.md §11) and the lowest-index
    arg-best machine (§7).  ``theta_rows=None`` skips the subtraction.
    Takes a (B, rows, K) stack the same way, over its last axis."""
    cost = _assemble_cost_plain(aggregate, r_rows, b_rows, loads, speeds,
                                mu, total_b, framework)
    k = cost.shape[-1]
    kidx = torch.arange(k, device=cost.device)
    best_val = torch.min(cost, dim=-1).values
    # lowest-index argmin via the iota-min trick
    best_idx = torch.where(cost <= best_val[..., None], kidx, k).min(
        dim=-1).values.to(torch.int32)
    # a masked sum of one nonzero term: exact, and 0 for a machine id
    # outside [0, K) as in the reference
    own = r_rows.long()[..., None] == kidx
    current = torch.sum(torch.where(own, cost, 0.0), dim=-1)
    dissat = current - best_val
    if theta_rows is not None:
        dissat = dissat - theta_rows
    return dissat, best_idx


def dissatisfaction_from_aggregate_plain(aggregate, row_assignment,
                                         node_weights, loads, speeds, mu,
                                         framework: str = "c", *,
                                         theta=None, total_weight=None):
    """Plain twin of :func:`dissatisfaction_from_aggregate_cuda`."""
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    return reduce_dissat_tile_plain(
        aggregate, row_assignment, node_weights, theta, loads, speeds, mu,
        total_weight, framework=framework)


def dissatisfaction_from_aggregate_batched_plain(aggregate, row_assignment,
                                                 node_weights, loads, speeds,
                                                 mu, framework: str = "c", *,
                                                 theta=None,
                                                 total_weight=None):
    """Plain twin of :func:`dissatisfaction_from_aggregate_batched_cuda`:
    kernel 1's twin over the leading batch axis, in the same order of
    operations, so element b is bitwise
    :func:`dissatisfaction_from_aggregate_plain` on element b's operands.
    ``total_weight`` (B,) defaults to each element's own weight sum."""
    if total_weight is None:
        total_weight = torch.stack([torch.sum(b) for b in node_weights])
    return reduce_dissat_tile_plain(
        aggregate, row_assignment, node_weights, theta, loads, speeds, mu,
        total_weight, framework=framework)


def cost_matrix_plain(adjacency, assignment, node_weights, loads, speeds,
                      mu, framework: str = "c", *, row_assignment=None,
                      total_weight=None):
    """Plain twin of :func:`cost_matrix_cuda`: the aggregate as a full
    float32 one-hot product, then the shared cost assembly."""
    k = loads.shape[0]
    if row_assignment is None:
        row_assignment = assignment
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    kidx = torch.arange(k, device=adjacency.device)
    onehot = (assignment.long()[:, None] == kidx).to(torch.float32)
    aggregate = adjacency.to(torch.float32) @ onehot
    return _assemble_cost_plain(aggregate, row_assignment, node_weights,
                                loads, speeds, mu, total_weight, framework)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _scalar(x, device) -> torch.Tensor:
    """A 0-d float32 device tensor; device tensors pass through, so the
    loop never copies a host number to the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _framework_code(framework: str) -> int:
    if framework not in _FRAMEWORK_CODE:
        raise ValueError(f"unknown framework {framework!r}")
    return _FRAMEWORK_CODE[framework]


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{status}")


def dissatisfaction_from_aggregate_cuda(aggregate, row_assignment,
                                        node_weights, loads, speeds, mu,
                                        framework: str = "c", *, theta=None,
                                        total_weight=None):
    """Kernel 1 on the card: ``(dissat (rows,) f32, best (rows,) i32)``
    from a (rows, K) f32 aggregate.  ``mu`` and ``total_weight`` may be
    device scalars (read by the kernel, no host round trip)."""
    from . import _build
    device = aggregate.device
    if device.type != "cuda":
        raise ValueError("dissatisfaction_from_aggregate_cuda needs CUDA "
                         "tensors")
    rows, k = aggregate.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}; got K={k}")
    _check("aggregate", aggregate, torch.float32, (rows, k), device)
    _check("row_assignment", row_assignment, torch.int32, (rows,), device)
    _check("node_weights", node_weights, torch.float32, (rows,), device)
    _check("loads", loads, torch.float32, (k,), device)
    _check("speeds", speeds, torch.float32, (k,), device)
    if theta is not None:
        _check("theta", theta, torch.float32, (rows,), device)
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    mu_t = _scalar(mu, device)
    tb_t = _scalar(total_weight, device)
    dissat = torch.empty((rows,), dtype=torch.float32, device=device)
    best = torch.empty((rows,), dtype=torch.int32, device=device)
    if rows == 0:
        return dissat, best
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.dissat_from_aggregate(
        _ptr(aggregate), _ptr(row_assignment), _ptr(node_weights),
        _ptr(theta), _ptr(loads), _ptr(speeds), _ptr(mu_t), _ptr(tb_t),
        _ptr(dissat), _ptr(best), rows, k, _framework_code(framework),
        ctypes.c_void_p(stream))
    _raise_on(status, "dissat_from_aggregate")
    launches["dissat_from_aggregate"] += 1
    return dissat, best


def dissatisfaction_from_aggregate_batched_cuda(aggregate, row_assignment,
                                                node_weights, loads, speeds,
                                                mu, framework: str = "c", *,
                                                theta=None,
                                                total_weight=None):
    """Kernel 3 on the card: kernel 1 over a fleet.  Operands carry a
    leading batch axis — aggregate (B, rows, K) f32, ``row_assignment``
    (B, rows) i32, ``node_weights`` and optional ``theta`` (B, rows) f32,
    ``loads``/``speeds`` (B, K) f32, ``mu``/``total_weight`` (B,) f32
    device tensors (``total_weight`` defaults to each element's own
    weight sum).  Returns ``(dissat (B, rows) f32, best (B, rows) i32)``,
    each element bitwise kernel 1 on that element's operands."""
    from . import _build
    device = aggregate.device
    if device.type != "cuda":
        raise ValueError("dissatisfaction_from_aggregate_batched_cuda needs "
                         "CUDA tensors")
    if aggregate.ndim != 3:
        raise ValueError(f"aggregate must be (B, rows, K); got shape "
                         f"{tuple(aggregate.shape)}")
    bsz, rows, k = aggregate.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}; got K={k}")
    if not 1 <= bsz <= MAX_BATCH:
        raise ValueError(f"the kernel takes 1 <= B <= {MAX_BATCH}; got "
                         f"B={bsz}")
    _check("aggregate", aggregate, torch.float32, (bsz, rows, k), device)
    _check("row_assignment", row_assignment, torch.int32, (bsz, rows),
           device)
    _check("node_weights", node_weights, torch.float32, (bsz, rows), device)
    if total_weight is None:
        total_weight = torch.stack([torch.sum(b) for b in node_weights])
    _check("loads", loads, torch.float32, (bsz, k), device)
    _check("speeds", speeds, torch.float32, (bsz, k), device)
    _check("mu", mu, torch.float32, (bsz,), device)
    _check("total_weight", total_weight, torch.float32, (bsz,), device)
    if theta is not None:
        _check("theta", theta, torch.float32, (bsz, rows), device)
    dissat = torch.empty((bsz, rows), dtype=torch.float32, device=device)
    best = torch.empty((bsz, rows), dtype=torch.int32, device=device)
    if rows == 0:
        return dissat, best
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.dissat_from_aggregate_batched(
        _ptr(aggregate), _ptr(row_assignment), _ptr(node_weights),
        _ptr(theta), _ptr(loads), _ptr(speeds), _ptr(mu), _ptr(total_weight),
        _ptr(dissat), _ptr(best), bsz, rows, k, _framework_code(framework),
        ctypes.c_void_p(stream))
    _raise_on(status, "dissat_from_aggregate_batched")
    launches["dissat_from_aggregate_batched"] += 1
    return dissat, best


def cost_matrix_cuda(adjacency, assignment, node_weights, loads, speeds, mu,
                     framework: str = "c", *, row_assignment=None,
                     total_weight=None):
    """Kernel 2 on the card: the (rows, K) f32 cost block of a (rows, N)
    adjacency row block.  ``assignment`` covers the N columns;
    ``row_assignment`` (default ``assignment``) the rows; ``total_weight``
    is the global B (default ``sum(node_weights)``, right only for the
    full square problem)."""
    from . import _build
    device = adjacency.device
    if device.type != "cuda":
        raise ValueError("cost_matrix_cuda needs CUDA tensors")
    rows, cols = adjacency.shape
    k = loads.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}; got K={k}")
    if row_assignment is None:
        row_assignment = assignment
    _check("adjacency", adjacency, torch.float32, (rows, cols), device)
    _check("assignment", assignment, torch.int32, (cols,), device)
    _check("row_assignment", row_assignment, torch.int32, (rows,), device)
    _check("node_weights", node_weights, torch.float32, (rows,), device)
    _check("loads", loads, torch.float32, (k,), device)
    _check("speeds", speeds, torch.float32, (k,), device)
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    mu_t = _scalar(mu, device)
    tb_t = _scalar(total_weight, device)
    out = torch.empty((rows, k), dtype=torch.float32, device=device)
    if rows == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.cost_matrix(
        _ptr(adjacency), _ptr(assignment), _ptr(row_assignment),
        _ptr(node_weights), _ptr(loads), _ptr(speeds), _ptr(mu_t),
        _ptr(tb_t), _ptr(out), rows, cols, k, _framework_code(framework),
        ctypes.c_void_p(stream))
    _raise_on(status, "cost_matrix")
    launches["cost_matrix"] += 1
    return out
