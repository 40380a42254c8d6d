"""Collective-traffic accounting for the dry run's roofline (the port's
counterpart of ``repro.launch.hlo_analysis.collective_stats``).

The reference parses the post-SPMD HLO for its collectives; the port runs
the cell's function on DTensors and watches the collectives DTensor
issues, under ``torch.distributed.tensor.debug.CommDebugMode``.  Each one's
bytes are the size of the tensor it returns on this rank (an all-gather's
gathered tensor, a reduce-scatter's shard, an all-reduce's tensor), as
the reference sums each collective's per-device result shape.  The port's
layers run in a Python loop, so a collective in a layer is seen once per
layer and needs no trip count.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# aten / c10d op names (overload packet, in-place "_" dropped) -> kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base": "all-gather",
    "allgather": "all-gather",
    "allgather_coalesced": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce": "all-reduce",
    "allreduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall": "all-to-all",
    "alltoall_base": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
}


def _kind(func) -> str | None:
    name = func._overloadpacket.__name__
    return _KINDS.get(name) or _KINDS.get(name.rstrip("_"))


def _result_bytes(out) -> int:
    leaves, _ = tree_flatten(out)
    return sum((math.prod(x.shape) if x.shape else 1) * x.element_size()
               for x in leaves if isinstance(x, torch.Tensor))


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's bytes by the
    reference's kind names.  ``last_op`` is the last op dispatched on
    DTensors (the one a failed run stopped at).  With ``budget_s``, a run
    still going after that many seconds raises ``TimeoutError``: DTensor's
    sharding propagation can take minutes an op on a 3-D mesh."""

    def __init__(self, budget_s: float | None = None):
        super().__init__()
        self.by_kind: dict[str, int] = defaultdict(int)
        self.count: dict[str, int] = defaultdict(int)
        self.last_op = None
        self.deadline = None if budget_s is None \
            else time.monotonic() + budget_s
        self.budget_s = budget_s

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise TimeoutError(f"the DTensor run passed its "
                               f"{self.budget_s:g} s budget")
        if any(issubclass(t, DTensor) for t in types):
            self.last_op = func
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator):
            return out
        kind = _kind(func)
        if kind is not None:
            self.by_kind[kind] += _result_bytes(out)
            self.count[kind] += 1
        return out


def stats(counter) -> dict:
    """{'total_bytes', 'by_kind': {kind: bytes}, 'count'} of a counter."""
    by_kind = {k: int(v) for k, v in counter.by_kind.items()}
    return {"total_bytes": int(sum(by_kind.values())), "by_kind": by_kind,
            "count": dict(counter.count)}


def collective_stats(fn, *args) -> dict:
    """{'total_bytes', 'by_kind', 'count'} of the collectives ``fn(*args)``
    issues on this rank."""
    with CollectiveCounter() as counter:
        fn(*args)
    return stats(counter)
