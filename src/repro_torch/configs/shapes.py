"""Assigned input shapes and ``meta``-tensor stand-ins for the dry run
(port of ``repro.configs.shapes``).

Every architecture is paired with all four LM shapes; ``train_*`` runs
``train_step``, ``prefill_*`` the prefill forward, and ``decode_*`` /
``long_*`` ``decode_step`` (one new token against a KV/SSM cache of
``seq_len``).  ``long_500k`` requires sub-quadratic attention and is skipped
for pure full-attention archs (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def shape_is_applicable(cfg, shape: Shape) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524288-token decode needs "
                       "sub-quadratic attention / constant-state decode "
                       "(DESIGN.md §5)")
    return True, ""


def input_specs(cfg, shape: Shape) -> dict:
    """``meta`` tensors standing in for every model input of this cell:
    the reference's shapes and dtypes, no storage."""
    B, S = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.input_kind == "embeddings":
            inputs = meta((B, S, cfg.d_model), f32)
        else:
            inputs = meta((B, S), i32)
        return {"inputs": inputs, "targets": meta((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.input_kind == "embeddings":
            return {"inputs": meta((B, S, cfg.d_model), f32)}
        return {"inputs": meta((B, S), i32)}
    # decode: one new token against a cache of S tokens
    if cfg.input_kind == "embeddings":
        return {"inputs": meta((B, 1, cfg.d_model), f32)}
    return {"inputs": meta((B, 1), i32)}
