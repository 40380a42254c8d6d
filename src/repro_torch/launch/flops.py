"""FLOP and byte accounting by watching the aten ops a function dispatches
(the port's counterpart of ``repro.launch.jaxpr_flops``).

``torch.utils.flop_counter.FlopCounterMode`` counts only matmuls,
convolutions and attention; the reference's jaxpr walk also counts
elementwise and transcendental work and a bytes-touched estimate.  This
``TorchDispatchMode`` follows the reference's rules on aten ops:

  * mm / bmm / addmm / baddbmm / matmul-like — 2 * batch * M * N * K exact
  * cheap elementwise (add, mul, where, compare, cumsum, ...) — one flop per
    output element
  * transcendental (exp, log, tanh, sigmoid, rsqrt, ...) — 8 per output
    element (polynomial approximations), as the reference counts them
  * reductions — one flop per input element
  * softmax / log-softmax — their decomposition: max and sum reductions,
    a subtraction, an exp and a division per element (12 per element)
  * SiLU / GELU — a transcendental and a multiply (9 per element)
  * everything else (copies, views, gathers, scatters, index ops) — bytes
    only

Bytes are the sizes of every op's tensor inputs plus outputs (the
reference's naive "bytes touched", an unfused upper bound).  The port's
layers run in a Python loop, so the loop itself is the count: a layer run
L times dispatches its ops L times, and no trip factor is needed.

Run on ``meta`` tensors (the dry run), every kernel wrapper takes its plain
twin (``kernels/flash_attention.py``, ``ssd_scan.py``,
``decode_attention.py``: any tensor not on ``cuda``), so the count is the
plain formula's — by design, not a fallback on the card's path.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log10", "tanh", "sigmoid",
                   "erf", "rsqrt", "sqrt", "sin", "cos", "log1p", "expm1",
                   "reciprocal"}
_CHEAP = {"add", "sub", "mul", "div", "maximum", "minimum", "max", "min",
          "neg", "abs", "bitwise_and", "bitwise_or", "bitwise_xor",
          "bitwise_not", "logical_and", "logical_or", "logical_xor",
          "logical_not", "where", "clamp", "clamp_min", "clamp_max", "floor",
          "ceil", "round", "trunc", "remainder", "fmod", "sign", "gt", "lt",
          "ge", "le", "eq", "ne", "square", "cumsum", "cumprod", "cummax",
          "cummin", "logcumsumexp", "addcmul", "addcdiv", "lerp",
          "masked_fill", "rsub", "floor_divide"}
_REDUCE = {"sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "any",
           "all", "var", "std", "var_mean", "norm", "linalg_vector_norm",
           "logsumexp"}
_SOFTMAX = {"_softmax", "_log_softmax", "softmax", "log_softmax"}
_ACTIVATION = {"silu", "gelu"}


def _numel(t) -> int:
    return math.prod(t.shape) if t.shape else 1


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(_numel(x) * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


def _dot_flops(name: str, args) -> int | None:
    """2 * batch * M * N * K for the matmul-like ops, else None."""
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * n * k
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * n * k
    if name == "bmm":
        (b, m, k), n = args[0].shape, args[1].shape[2]
        return 2 * b * m * n * k
    if name == "baddbmm":
        (b, m, k), n = args[1].shape, args[2].shape[2]
        return 2 * b * m * n * k
    if name in ("mv", "dot", "vdot"):
        return 2 * _numel(args[0])
    return None


def op_flops(name: str, args, out) -> int:
    """FLOPs the reference's rules give one aten op (``name`` without its
    overload, an in-place op's trailing ``_`` dropped)."""
    dot = _dot_flops(name, args)
    if dot is not None:
        return dot
    outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
    out_size = sum(_numel(x) for x in outs)
    if name in _TRANSCENDENTAL:
        return 8 * out_size
    if name == "pow":
        exponent = args[1] if len(args) > 1 else None
        integer = isinstance(exponent, int) or (
            isinstance(exponent, float) and exponent.is_integer())
        return out_size if integer else 8 * out_size
    if name in _CHEAP:
        return out_size
    if name in _SOFTMAX:
        return 12 * out_size
    if name in _ACTIVATION:
        return 9 * out_size
    if name in _REDUCE:
        return _numel(args[0]) if isinstance(args[0], torch.Tensor) else 0
    return 0


class FlopCounter(TorchDispatchMode):
    """Counts the reference's FLOPs and naive bytes of every aten op
    dispatched inside it (forward, backward, optimizer, all of it)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__.rstrip("_")
        self.flops += op_flops(name, args, out)
        self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def count_fn(fn, *args) -> tuple[int, int]:
    """(flops, naive_bytes) of ``fn(*args)``."""
    with FlopCounter() as counter:
        fn(*args)
    return counter.flops, counter.bytes
