"""Gradient compression for the data-parallel all-reduce (port of
``repro.training.compression``).

Int8 symmetric quantization with error feedback [1-bit Adam lineage]: the
quantization residual is carried to the next step so compression bias does
not accumulate.  ``compressed_psum`` reduces over a ``torch.distributed``
process group (the default group when ``group`` is None), where the
reference reduces over a named axis; ``round`` is half-to-even in both.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .tree import flatten, map_tree, unflatten


def compress_int8(x: torch.Tensor):
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads, errors, group=None):
    """Mean over ``group``'s ranks with int8 error-feedback compression.

    grads/errors: trees (errors the same structure, f32).  Returns
    (mean_grads, new_errors)."""
    n = float(dist.get_world_size(group))

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = compress_int8(g32)
        deq = decompress_int8(q, scale)
        new_e = g32 - deq
        # the dequantised payload is summed; each rank's scale rides in it
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        return (deq / n).to(g.dtype), new_e

    _, flat_g = flatten(grads)
    _, flat_e = flatten(errors)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def init_errors(grads):
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
