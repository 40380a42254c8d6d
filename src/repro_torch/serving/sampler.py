"""Token samplers for the serving engine (port of
``repro.serving.sampler``): pure functions of the logits, with the
randomness drawn from an explicit ``torch.Generator``."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, 1, V) or (B, V) -> (B,) int32; the lowest index on
    ties, as ``jnp.argmax``."""
    if logits.ndim == 3:
        logits = logits[:, -1, :]
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_logits(generator: torch.Generator, logits: torch.Tensor, *,
                  temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature + optional top-k sampling.  logits: (B, 1, V) or
    (B, V) -> (B,) int32, drawn from ``generator`` (on the logits'
    device)."""
    if logits.ndim == 3:
        logits = logits[:, -1, :]
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
