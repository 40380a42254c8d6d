"""Continuous-batching serving engine (port of ``repro.serving.engine``).

The engine owns a fixed pool of ``max_batch`` cache slots over one batched
:class:`~repro_torch.models.transformer.DecodeCache` with *per-slot*
positions, so sequences of different lengths decode together in one
``decode_step`` (kernel 6 reads each slot's own valid length).

Scheduling is host-side Python, as in the reference: the same admission
order, slot pool, budgets and stats.  Tensor work is two calls:

  * ``prefill``      — B=1 prompt prefill (kernel 7 per attention layer
                       of a dense or MoE model and per application of a
                       hybrid's shared block, kernel 8 per Mamba2 layer of
                       an SSM or hybrid) producing a slot-shaped cache,
                       copied into the free slot;
  * ``decode_step``  — one token for every slot (kernel 6 per attention
                       layer or shared-block application; the Mamba2 step
                       is plain PyTorch; an MoE runs dropless).

Idle slots decode garbage that is masked out on the host; their positions
advance too, and a KV write past ``max_len`` lands on the last row, as XLA
clamps the reference's.  Each step's tokens are read to the host.  The
weights are cast to the compute dtype once, when the engine is built
(:func:`~repro_torch.models.transformer.cast_params`), instead of at every
use; the values are the same.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import (DecodeCache, cast_params, decode_step,
                                  init_cache, prefill)
from .sampler import greedy


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8           # cache slots
    max_len: int = 512           # per-slot KV/SSM capacity
    eos_id: int = -1             # -1 = never stop on a token
    cache_dtype: str = "bfloat16"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (S,) int32 token ids
    max_new_tokens: int
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _write_slot(batched: DecodeCache, single: DecodeCache, slot: int,
                position) -> DecodeCache:
    """Copy a B=1 cache into slot ``slot`` of the batched cache, in place
    (cast to the batched cache's dtype): its keys and values, SSM states
    and conv windows, whichever the model has (a hybrid has all four); the
    slot's previous contents are overwritten, not added to."""
    for dst, src in ((batched.kv_k, single.kv_k),
                     (batched.kv_v, single.kv_v),
                     (batched.ssm_state, single.ssm_state),
                     (batched.ssm_conv, single.ssm_conv)):
        if dst is not None:
            dst[:, slot] = src[:, 0]
    batched.position[slot] = position
    return batched


class ServingEngine:
    """Continuous batching over a fixed slot pool.

    >>> eng = ServingEngine(cfg, params, ServeConfig(max_batch=4, max_len=256))
    >>> eng.submit(Request(0, prompt, max_new_tokens=32))
    >>> stats = eng.run()          # drains the queue

    ``attention="plain"`` runs the kernels' twins instead of kernels 6–7,
    ``ssm="plain"`` the twin instead of kernel 8; a hybrid takes both.
    """

    def __init__(self, cfg: ModelConfig, params: dict, serve: ServeConfig,
                 sampler=greedy, attention: str = "kernel",
                 ssm: str = "kernel"):
        self.cfg = cfg
        self.params = cast_params(params, cfg.cdtype())
        self.serve = serve
        self.sampler = sampler
        self.attention = attention
        self.ssm = ssm
        self.device = params["final_norm"].device
        b, s = serve.max_batch, serve.max_len
        cache = init_cache(cfg, b, s, getattr(torch, serve.cache_dtype),
                           self.device)
        # per-slot positions (the decode path broadcasts (B,) positions)
        self.cache = cache._replace(position=torch.zeros(
            (b,), dtype=torch.int32, device=self.device))
        self.slots: list[Optional[Request]] = [None] * b
        self.budget = np.zeros(b, np.int64)      # remaining new tokens
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.steps = 0
        self.prefills = 0
        # host seconds in prefill and in decode steps (each ends in a read
        # of the sampled tokens, so the device work is done), prompt tokens
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.prefill_tokens = 0

    # ----- scheduling --------------------------------------------------
    def submit(self, request: Request) -> None:
        if request.prompt.ndim != 1 or request.prompt.size < 1:
            raise ValueError("a prompt is a non-empty (S,) array of ids")
        if request.prompt.size + request.max_new_tokens > self.serve.max_len:
            raise ValueError("request exceeds slot capacity")
        self.queue.append(request)

    def _admit(self) -> None:
        for slot in range(self.serve.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            tokens = torch.as_tensor(req.prompt.astype(np.int64),
                                     device=self.device)[None, :]
            logits, single = prefill(self.params, self.cfg, tokens,
                                     self.serve.max_len,
                                     attention=self.attention, ssm=self.ssm)
            first = int(self.sampler(logits)[0])
            req.output.append(first)
            self.cache = _write_slot(self.cache, single, slot,
                                     req.prompt.size)
            del single
            self.prefill_s += time.perf_counter() - t0
            self.prefill_tokens += int(req.prompt.size)
            self.slots[slot] = req
            self.budget[slot] = req.max_new_tokens - 1
            self.prefills += 1
            if (first == self.serve.eos_id) or self.budget[slot] <= 0:
                self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        self.finished.append(req)
        self.slots[slot] = None
        self.budget[slot] = 0

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # ----- decode loop ---------------------------------------------------
    def step(self) -> None:
        """Admit waiting requests, then decode one token for every slot."""
        self._admit()
        if self.num_active == 0:
            return
        t0 = time.perf_counter()
        last = np.zeros((self.serve.max_batch, 1), np.int64)
        for slot, req in enumerate(self.slots):
            if req is not None:
                last[slot, 0] = req.output[-1]
        logits, self.cache = decode_step(
            self.params, self.cfg, torch.as_tensor(last, device=self.device),
            self.cache, attention=self.attention)
        token = self.sampler(logits).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.steps += 1
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            t = int(token[slot])
            req.output.append(t)
            self.budget[slot] -= 1
            if t == self.serve.eos_id or self.budget[slot] <= 0:
                self._finish(slot)

    def run(self, max_steps: int = 100_000) -> dict:
        """Drain the queue; returns throughput stats (the reference's keys,
        then the prefill and decode split)."""
        t0 = time.perf_counter()
        while (self.queue or self.num_active) and self.steps < max_steps:
            self.step()
        wall = time.perf_counter() - t0
        toks = sum(len(r.output) for r in self.finished)
        return {"requests": len(self.finished), "decode_steps": self.steps,
                "prefills": self.prefills, "generated_tokens": toks,
                "wall_s": wall, "tok_per_s": toks / max(wall, 1e-9),
                "prefill_s": self.prefill_s,
                "prefill_tokens": self.prefill_tokens,
                "decode_s": self.decode_s}
