"""Hand-written CUDA kernels for the refinement hot spot, with their plain
PyTorch twins (DESIGN.md §3.2, §10).

Three kernels, all in ``csrc/dissatisfaction.cu`` and built by
:mod:`repro_torch.kernels._build`:

* ``dissat_from_aggregate`` — replaces the TPU kernel
  ``repro.kernels.dissatisfaction.dissatisfaction_from_aggregate_pallas``.
  The incremental path carries the (rows, K) aggregate; one thread per
  row loads its A row (into registers with 16-byte loads up to K = 32,
  straight from device memory beyond), assembles
  the K costs and writes only ``(dissat, best)``.  The (rows, K) cost
  matrix never reaches device memory.  K is a compile-time constant for
  :data:`SPECIALISED_K`.
* ``dissat_from_aggregate_batched`` — replaces
  ``dissatisfaction_from_aggregate_batched_pallas``: the same kernel body
  over a (B, rows, K) fleet stack on a (row blocks, B) grid, each element
  reading its own machine table and scalars, so each element is bitwise
  kernel 1's (DESIGN.md §12.3); kernel 1 is its B = 1 case.
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
kernel launch adds one to :data:`launches`.  The launch path of kernels 1
and 3 runs once per refinement turn, so it is kept lean: each check is
one comparison (its message is built only when it fails), device scalars
pass as they are, pointers go to the C entry point as plain ints, and no
call waits on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.costs import per_element, row_sum

MAX_K = 128      # machines the kernels take (shared-memory slots per row)
MAX_BATCH = 65535   # fleet elements kernel 3 takes (its grid's y extent)
# K with a compile-time instance of kernels 1 and 3 (the cases of
# launch_dissat in csrc/dissatisfaction.cu); every other K up to MAX_K
# takes the runtime-K instance
SPECIALISED_K = (2, 4, 8, 16, 32, 64, 128)

# kernel name -> launches since the last reset_launches()
launches = {"dissat_from_aggregate": 0, "cost_matrix": 0,
            "dissat_from_aggregate_batched": 0}

_FRAMEWORK_CODE = {"c": 0, "ct": 1}
_F32, _I32 = torch.float32, torch.int32


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

def _check(name: str, t: torch.Tensor, dtype, shape: tuple,
           device) -> None:
    if not (isinstance(t, torch.Tensor) and t.device == device
            and t.dtype is dtype and t.shape == shape
            and t.is_contiguous()):
        _refuse(name, t, dtype, shape, device)


def _refuse(name: str, t, dtype, shape: tuple, device) -> None:
    """Raise the ValueError that says why ``t`` failed :func:`_check`."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got "
                         f"{tuple(t.shape)}")
    raise ValueError(f"{name} must be contiguous")


def _scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``device``: such a tensor comes
    back as it is, another tensor is moved or cast there (a device tensor
    never goes through the host), a Python number is put there."""
    if isinstance(x, torch.Tensor):
        if x.dtype is _F32 and x.ndim == 0 and x.device == device:
            return x
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


def check_dissat_operands(aggregate, row_assignment, node_weights, loads,
                          speeds, theta=None, mu=None, total_weight=None, *,
                          device, batched: bool = False):
    """The operand checks of kernels 1 and 3, on any device (so they run
    on the CPU too): raises ValueError on what the kernels do not take and
    returns ``(B, rows, K)``, B = 1 for kernel 1.  Kernel 3
    (``batched=True``) takes a leading B axis on every operand, and its
    ``mu`` and a given ``total_weight`` must be (B,) float32 tensors on
    ``device``; kernel 1's scalars are converted by its wrapper instead."""
    shape = aggregate.shape
    if len(shape) != 2 + batched:
        raise ValueError(f"aggregate must be ({'B, ' if batched else ''}"
                         f"rows, K); got shape {tuple(shape)}")
    bsz, rows, k = shape if batched else (1, *shape)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}; got K={k}")
    if not 1 <= bsz <= MAX_BATCH:
        raise ValueError(f"the kernel takes 1 <= B <= {MAX_BATCH}; got "
                         f"B={bsz}")
    lead = (bsz,) if batched else ()
    per_row, per_machine = lead + (rows,), lead + (k,)
    _check("aggregate", aggregate, _F32, shape, device)
    _check("row_assignment", row_assignment, _I32, per_row, device)
    _check("node_weights", node_weights, _F32, per_row, device)
    _check("loads", loads, _F32, per_machine, device)
    _check("speeds", speeds, _F32, per_machine, device)
    if batched:
        _check("mu", mu, _F32, lead, device)
        if total_weight is not None:
            _check("total_weight", total_weight, _F32, lead, device)
    if theta is not None:
        _check("theta", theta, _F32, per_row, device)
    return bsz, rows, k


# the C entry points of csrc/dissatisfaction.cu, bound at first use
_entry_points: dict = {}


def _entry_point(name: str):
    fn = _entry_points.get(name)
    if fn is None:
        from . import _build
        fn = _entry_points[name] = getattr(_build.library(), name)
    return fn


def _stream(device) -> int:
    """PyTorch's current stream on ``device``, as a cudaStream_t.  This is
    a private PyTorch call (``torch.cuda.current_stream(device).cuda_stream``
    is the public one, ~4 us a call slower on an H100 host);
    ``tests/test_torch_gpu.py`` fails plainly if a PyTorch release drops
    it."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def dissatisfaction_from_aggregate_cuda(aggregate, row_assignment,
                                        node_weights, loads, speeds, mu,
                                        framework: str = "c", *, theta=None,
                                        total_weight=None):
    """Kernel 1 on the card: ``(dissat (rows,) f32, best (rows,) i32)``
    from a (rows, K) f32 aggregate.  ``mu`` and ``total_weight`` may be
    device scalars (read by the kernel, no host round trip); a Python
    number, or a tensor of another dtype or device, is converted."""
    if not aggregate.is_cuda:
        raise ValueError("dissatisfaction_from_aggregate_cuda needs CUDA "
                         "tensors")
    device = aggregate.device
    _, rows, k = check_dissat_operands(aggregate, row_assignment,
                                       node_weights, loads, speeds, theta,
                                       device=device)
    code = _framework_code(framework)
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    mu_t = _scalar(mu, device)
    tb_t = _scalar(total_weight, device)
    dissat = torch.empty_like(node_weights)
    best = torch.empty_like(row_assignment)
    if rows == 0:
        return dissat, best
    status = _entry_point("dissat_from_aggregate")(
        aggregate.data_ptr(), row_assignment.data_ptr(),
        node_weights.data_ptr(), None if theta is None else theta.data_ptr(),
        loads.data_ptr(), speeds.data_ptr(), mu_t.data_ptr(),
        tb_t.data_ptr(), dissat.data_ptr(), best.data_ptr(), rows, k, code,
        _stream(device))
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
    if not aggregate.is_cuda:
        raise ValueError("dissatisfaction_from_aggregate_batched_cuda needs "
                         "CUDA tensors")
    device = aggregate.device
    bsz, rows, k = check_dissat_operands(
        aggregate, row_assignment, node_weights, loads, speeds, theta, mu,
        total_weight, device=device, batched=True)
    if total_weight is None:
        total_weight = torch.stack([torch.sum(b) for b in node_weights])
    code = _framework_code(framework)
    dissat = torch.empty_like(node_weights)
    best = torch.empty_like(row_assignment)
    if rows == 0:
        return dissat, best
    status = _entry_point("dissat_from_aggregate_batched")(
        aggregate.data_ptr(), row_assignment.data_ptr(),
        node_weights.data_ptr(), None if theta is None else theta.data_ptr(),
        loads.data_ptr(), speeds.data_ptr(), mu.data_ptr(),
        total_weight.data_ptr(), dissat.data_ptr(), best.data_ptr(), bsz,
        rows, k, code, _stream(device))
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
