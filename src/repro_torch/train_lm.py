"""End-to-end example: train a ~100M-parameter MoE LM with checkpoint/
restart fault tolerance and the game-theoretic expert planner rebalancing
experts from live router statistics (port of ``examples/train_lm.py``).

It uses a ~100M-param granite-MoE-style config (not the reduced smoke
config), registered with ``configs.register_config`` so
``launch.train`` resolves it by name; runs on the card unless
``--device cpu`` (kernel 7 in every attention layer's forward, kernel 1 in
every replan's refinement turns), checkpoints periodically, and — to
demonstrate restart — stops halfway and resumes from its checkpoint when
``--demo-restart`` is set.  One card has no mesh: ``GROUPS`` stands in
for the reference's model axis, the expert groups the planner balances
over.

  PYTHONPATH=src python -m repro_torch.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.train_lm --steps 40 --demo-restart
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch import configs
from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig

GROUPS = 4  # the reference's model-axis width


def midi_config() -> ModelConfig:
    """~100M-active-param MoE (granite-moe family, scaled between smoke and
    the published 1b-a400m config)."""
    base = configs.get_config("granite-moe-1b-a400m")
    return dataclasses.replace(
        base, name="granite-moe-100m",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=16384, num_experts=16, top_k=4,
        moe_group_size=256, param_dtype="float32", compute_dtype="float32")


def run(*, steps: int = 300, batch: int = 8, seq: int = 256,
        ckpt_dir: str | None = None, demo_restart: bool = False,
        fresh: bool = False, device: str = "cuda"):
    """The example; returns the (state, losses) of each ``train`` call."""
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_train_lm")
    if fresh and os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)

    cfg = midi_config()
    print(f"[example] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.active_param_count() / 1e6:.1f}M active) on {device}")
    # register the custom config so launch.train can resolve it by name
    configs.register_config(cfg)

    runs = []
    if demo_restart:
        half = steps // 2
        print(f"[example] phase 1: train to step ~{half}, then simulate a "
              f"crash and restart")
        runs.append(train(cfg.name, smoke=False, steps=half,
                          global_batch=batch, seq_len=seq,
                          ckpt_dir=ckpt_dir, ckpt_every=max(half // 2, 1),
                          replan=10, groups=GROUPS, device=device))
        print("[example] --- simulated crash; relaunching ---")

    runs.append(train(cfg.name, smoke=False, steps=steps, global_batch=batch,
                      seq_len=seq, ckpt_dir=ckpt_dir,
                      ckpt_every=max(steps // 5, 1), replan=25,
                      groups=GROUPS, device=device))
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_train_lm "
                         "under the temp directory)")
    ap.add_argument("--demo-restart", action="store_true")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_dir=args.ckpt_dir, demo_restart=args.demo_restart,
               fresh=args.fresh, device=args.device)


if __name__ == "__main__":
    main()
