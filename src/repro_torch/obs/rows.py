"""Telemetry rows kept on the device, and the read-back after a run.

The reference streams a refinement turn's or a DES tick's row to the host
through ``jax.debug.callback``.  The port's loops are host loops over
device tensors that read the card only every few dozen turns or ticks, so
a row is written to a buffer on the device instead — by plain tensor
operations, which a CUDA graph can capture — and the buffer is read back
in one transfer when the run ends (:func:`read_back`).

A row is a vector of 32-bit columns: ``int32`` values as they are, ``f32``
values bit-cast (exact both ways), booleans as 0/1.  :func:`decode`
splits the host copy back into typed columns.
"""
from __future__ import annotations

import numpy as np
import torch


def read_back(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Host numpy copies of ``tensors`` (each on any device, any dtype) in
    one device→host transfer: one host sync however many there are."""
    if not tensors:
        return []
    flat = [t.detach().reshape(-1).contiguous() for t in tensors]
    dev = flat[0].device
    host = torch.cat([f.to(dev).view(torch.uint8) for f in flat]).cpu() \
        .numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        size = f.numel() * f.element_size()
        dtype = torch.empty(0, dtype=f.dtype).numpy().dtype
        out.append(host[at:at + size].view(dtype).reshape(tuple(t.shape)))
        at += size
    return out


def bits(x: torch.Tensor) -> torch.Tensor:
    """A boolean, int32 or f32 tensor as int32 (f32 bit-cast)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.to(torch.int32)


def decode(rows: np.ndarray, kinds: str) -> list[np.ndarray]:
    """Split (T, C) host rows into their C columns: ``kinds[j]`` is ``"b"``
    (bool), ``"i"`` (int32) or ``"f"`` (f32, bit-cast back)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1, len(kinds))
    cols = []
    for j, kind in enumerate(kinds):
        col = np.ascontiguousarray(rows[:, j])
        cols.append(col.view(np.float32) if kind == "f"
                    else col.astype(bool) if kind == "b" else col)
    return cols


# TurnRows merges this many rows into one tensor.
_BLOCK = 64


class TurnRows:
    """Rows appended one a turn by a host loop: each :meth:`append` stacks
    the turn's 0-d columns into one row on the device (no host read), and
    every ``_BLOCK`` rows merge into one tensor so the host holds few.
    :meth:`tensor` is every row so far, (T, C) int32 on the device."""

    def __init__(self):
        self._rows: list[torch.Tensor] = []
        self._blocks: list[torch.Tensor] = []

    def append(self, *cols: torch.Tensor) -> None:
        self._rows.append(torch.stack([bits(c) for c in cols]))
        if len(self._rows) == _BLOCK:
            self._blocks.append(torch.stack(self._rows))
            self._rows = []

    def tensor(self, width: int, device) -> torch.Tensor:
        parts = self._blocks + ([torch.stack(self._rows)]
                                if self._rows else [])
        if not parts:
            return torch.zeros((0, width), dtype=torch.int32, device=device)
        return torch.cat(parts)


class TickRows:
    """A fixed (capacity + 1, width) int32 buffer on the device, written
    inside a step that a CUDA graph may capture: :meth:`write` puts a row
    at the write pointer when its 0-d ``pred`` holds (else at the spare
    last row) and advances the pointer, all in place — no host read.
    The host empties it (:meth:`drain`) before ``capacity`` rows can have
    been written since the last drain."""

    def __init__(self, capacity: int, width: int, device):
        self.capacity = capacity
        self.buf = torch.zeros((capacity + 1, width), dtype=torch.int32,
                               device=device)
        self.ptr = torch.zeros((), dtype=torch.int64, device=device)
        self._host: list[np.ndarray] = []

    def write(self, pred: torch.Tensor, *cols: torch.Tensor) -> None:
        row = torch.stack([bits(c) for c in cols])
        at = torch.where(pred, self.ptr, self.capacity).reshape(1)
        self.buf.index_copy_(0, at, row[None])
        self.ptr.add_(pred.to(torch.int64))

    def patch_last(self, t: torch.Tensor, updates: dict) -> None:
        """Overwrite columns (``{column: 0-d value}``) of the last row
        written, if it is tick ``t``'s (its column 0)."""
        at = torch.clamp(self.ptr - 1, min=0).reshape(1)
        row = self.buf.index_select(0, at)[0]
        new = row.clone()
        for col, value in updates.items():
            new[col] = bits(value)
        hit = (self.ptr > 0) & (row[0] == t.to(torch.int32))
        self.buf.index_copy_(0, at, torch.where(hit, new, row)[None])

    def drain(self, *more: torch.Tensor) -> list[np.ndarray]:
        """Read the rows written so far to the host and start the buffer
        over; ``more`` tensors come back in the same transfer (returned)."""
        ptr, buf, *extra = read_back(self.ptr, self.buf, *more)
        self._host.append(buf[:int(ptr)])
        self.ptr.zero_()
        return extra

    def rows(self) -> np.ndarray:
        """Every row drained so far, (T, width) int32 on the host."""
        width = self.buf.shape[1]
        return (np.concatenate(self._host) if self._host
                else np.zeros((0, width), np.int32))
