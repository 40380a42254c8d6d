"""Synthetic data pipeline: deterministic, seekable, shardable (port of
``repro.training.data``).

Tokens follow a Zipf-like marginal with short-range Markov structure, so
cross-entropy genuinely decreases during the example training runs (a
uniform stream would pin the loss at log V).  ``synthetic_batch`` is
pure-functional in (config, step) — restart-safe resumption needs no data
state in checkpoints, and each data-parallel host slices its own rows.
The draws are the reference's numpy draws, so tokens, targets and
pseudo-embeddings are bitwise the reference's; only the returned
containers are torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.problem import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.2
    markov_period: int = 16
    seed: int = 0
    input_kind: str = "tokens"
    d_model: int = 0                  # for embeddings-input archs


def synthetic_batch(cfg: SyntheticDataConfig, step: int,
                    device=None) -> dict:
    """Batch for ``step`` (host-side numpy, then tensors on ``device``,
    default the card): int32 ``targets`` (B, S) and ``inputs``, int32 ids
    (B, S) or f32 embeddings (B, S, d)."""
    device = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    v = cfg.vocab_size
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = ranks ** (-cfg.zipf_a)
    probs /= probs.sum()
    base = rng.choice(v, size=(cfg.global_batch, cfg.seq_len), p=probs)
    # short-range structure: every markov_period-th token repeats its
    # predecessor, giving the model something learnable
    idx = np.arange(cfg.seq_len)
    mask = (idx % cfg.markov_period) == (cfg.markov_period - 1)
    base[:, 1:][:, mask[1:]] = base[:, :-1][:, mask[1:]]
    tokens = base.astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = tokens[:, 0]
    batch = {"targets": torch.from_numpy(targets).to(device)}
    if cfg.input_kind == "embeddings":
        # modality stub: deterministic pseudo-embeddings derived from ids
        emb_rng = np.random.default_rng(cfg.seed + 1)
        table = emb_rng.standard_normal((v, cfg.d_model)).astype(np.float32)
        batch["inputs"] = torch.from_numpy(table[tokens]).to(device)
    else:
        batch["inputs"] = torch.from_numpy(tokens).to(device)
    return batch
