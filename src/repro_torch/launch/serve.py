"""Serving driver: continuous batching over the slot-pool engine (port of
``repro.launch.serve``).  Runs on the card unless ``--device cpu``;
weights are random, from the seed.  All four families serve: dense
(``--arch qwen1.5-4b``, ...), MoE (``--arch granite-moe-1b-a400m``,
``qwen3-moe-235b-a22b``), SSM (``--arch mamba2-1.3b``) and hybrid
(``--arch zamba2-7b``); smoke width unless ``--full``.  With
``--ckpt-dir`` the weights are the ``params`` of the newest checkpoint
that ``repro_torch.launch.train`` wrote there.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --requests 16 --max-new 24 --slots 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
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
from repro_torch.training import checkpoint


def serve(arch: str, *, smoke: bool = True, requests: int = 16,
          max_new: int = 24, slots: int = 4, max_len: int = 256,
          temperature: float = 0.0, ckpt_dir: str | None = None,
          seed: int = 0, device: str = "cuda"):
    """Serve ``requests`` random prompts; returns the engine's stats, with
    each request's tokens under ``outputs`` ({uid: tokens})."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    if ckpt_dir:
        restored, step = checkpoint.restore(ckpt_dir, params,
                                            prefix="params")
        if restored is not None:
            params = restored
            print(f"[serve] loaded checkpoint step {step}")

    sampler = None
    if temperature > 0:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        sampler = lambda logits: sample_logits(gen, logits,  # noqa: E731
                                               temperature=temperature)
    eng = ServingEngine(cfg, params,
                        ServeConfig(max_batch=slots, max_len=max_len,
                                    cache_dtype="float32"),
                        **({"sampler": sampler} if sampler else {}))
    rng = np.random.default_rng(seed)
    for i in range(requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(4, max(5, max_len // 8)))
                              ).astype(np.int32)
        eng.submit(Request(i, prompt, max_new_tokens=max_new))
    stats = eng.run()
    stats["outputs"] = {r.uid: list(r.output) for r in eng.finished}
    print(f"[serve] {stats['requests']} requests | "
          f"{stats['generated_tokens']} tokens | "
          f"{stats['decode_steps']} batched decode steps | "
          f"{stats['tok_per_s']:.1f} tok/s on {device}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="a config of any family: "
                         + ", ".join(configs.all_archs()))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest checkpoint of "
                         "repro_torch.launch.train in this directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve(args.arch, smoke=args.smoke, requests=args.requests,
          max_new=args.max_new, slots=args.slots, max_len=args.max_len,
          temperature=args.temperature, ckpt_dir=args.ckpt_dir,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
