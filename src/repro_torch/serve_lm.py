"""Serve a small model with batched requests through the continuous-
batching engine (port of ``examples/serve_lm.py``).  Runs on the card
unless ``--device cpu``: kernel 7 in every prefill's attention layers,
kernel 6 in every decode step's.  ``--temperature`` > 0 samples each token
with ``serving.sampler.sample_logits`` from an explicit generator seeded
1 on the device, so a run is deterministic for its seeds.

  PYTHONPATH=src python -m repro_torch.serve_lm --requests 16
  PYTHONPATH=src python -m repro_torch.serve_lm --temperature 0.8 \\
      --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import init_params
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.sampler import sample_logits


def run(arch: str = "qwen1.5-4b", *, requests: int = 16, max_new: int = 24,
        slots: int = 4, temperature: float = 0.0, device: str = "cuda",
        params=None, verbose: bool = True):
    """The example on ``arch``'s smoke config; ``params`` default to
    ``init_params`` from seed 0 on ``device``.  Returns (stats, engine):
    ``engine.finished`` holds each request's tokens."""
    cfg = configs.get_smoke_config(arch)
    if params is None:
        params = init_params(cfg, 0, device=device)
    sampler = None
    if temperature > 0:
        gen = torch.Generator(device=device).manual_seed(1)
        sampler = lambda logits: sample_logits(  # noqa: E731
            gen, logits, temperature=temperature)

    eng = ServingEngine(cfg, params,
                        ServeConfig(max_batch=slots, max_len=128,
                                    cache_dtype="float32"),
                        **({"sampler": sampler} if sampler else {}))
    rng = np.random.default_rng(0)
    for i in range(requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(4, 24))).astype(np.int32)
        eng.submit(Request(i, prompt, max_new_tokens=max_new))

    stats = eng.run()
    if verbose:
        print(f"[serve] {stats['requests']} requests | "
              f"{stats['generated_tokens']} tokens | "
              f"{stats['decode_steps']} batched decode steps | "
              f"{stats['tok_per_s']:.1f} tok/s (smoke config on {device})")
        for r in eng.finished[:3]:
            print(f"  req {r.uid}: prompt[{r.prompt.size}] -> "
                  f"{r.output[:8]}...")
    return stats, eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.arch, requests=args.requests, max_new=args.max_new,
               slots=args.slots, temperature=args.temperature,
               device=args.device)


if __name__ == "__main__":
    main()
