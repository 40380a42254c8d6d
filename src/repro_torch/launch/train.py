"""Training driver: data -> train_step -> checkpoints -> planner (port of
``repro.launch.train``).  Runs on the card unless ``--device cpu``.

  * auto-resume from the newest checkpoint in ``--ckpt-dir`` (kill and
    relaunch anywhere: the run continues bit-exact),
  * the game-theoretic expert ``PartitionPlanner`` re-permuting the MoE
    experts from live router statistics every ``--replan`` steps.

One card has no mesh: ``--groups`` (default 1) stands in for the
reference's ``mesh.shape["model"]``, the expert groups the planner
balances over.  Smoke width unless ``--full``.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --steps 50 --batch 8 --seq 128 \\
      --replan 10 --groups 4 --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.sharding.planner import PartitionPlanner
from repro_torch.training import checkpoint
from repro_torch.training.data import SyntheticDataConfig, synthetic_batch
from repro_torch.training.train_step import (TrainHyper, init_train_state,
                                             make_train_step)


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          global_batch: int = 8, seq_len: int = 128,
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          replan: int = 0, groups: int = 1, microbatches: int = 1,
          schedule: str | None = None, log_every: int = 10, seed: int = 0,
          device: str = "cuda"):
    """Train ``arch`` for ``steps`` steps from seed ``seed`` (or from the
    newest checkpoint in ``ckpt_dir``); returns (state, losses of the
    steps run)."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    hyper = TrainHyper(
        total_steps=steps, warmup=max(steps // 10, 1),
        microbatches=microbatches,
        schedule=schedule or ("wsd" if "minicpm" in arch else "cosine"),
        wsd_stable=int(steps * 0.6), wsd_decay=int(steps * 0.3))
    step_fn = make_train_step(cfg, hyper)

    state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(seed))
    start_step = 0
    if ckpt_dir:
        restored, at = checkpoint.restore(ckpt_dir, state)
        if restored is not None:
            state, start_step = restored, at
            print(f"[train] resumed from checkpoint step {at}")

    data_cfg = SyntheticDataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        input_kind=cfg.input_kind, d_model=cfg.d_model)
    planner = PartitionPlanner(num_groups=groups,
                               interval=replan) if replan else None

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch = synthetic_batch(data_cfg, step, device=device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={float(metrics['loss']):.4f}"
                  f" ce={float(metrics['ce']):.4f}"
                  f" gnorm={float(metrics['grad_norm']):.3f}"
                  f" lr={float(metrics['lr']):.2e}")
        if planner is not None:
            state, stats = planner.maybe_replan(step + 1, state)
            if stats:
                print(f"[planner] step={step + 1} expert rebalance: "
                      f"imbalance {stats['imbalance_before']:.3f} -> "
                      f"{stats['imbalance_after']:.3f} "
                      f"({stats['moves']} moves)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, step + 1, state)
    wall = time.time() - t0
    if losses:
        print(f"[train] {steps - start_step} steps in {wall:.1f}s "
              f"({(steps - start_step) / max(wall, 1e-9):.2f} it/s); "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="a config of any family: "
                         + ", ".join(configs.all_archs()))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--replan", type=int, default=0,
                    help="expert-placement replan interval (0 = off)")
    ap.add_argument("--groups", type=int, default=1,
                    help="expert groups the planner balances over (the "
                         "reference's model-axis width)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--schedule", default=None, choices=[None, "cosine", "wsd"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.arch, smoke=args.smoke, steps=args.steps,
          global_batch=args.batch, seq_len=args.seq,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          replan=args.replan, groups=args.groups,
          microbatches=args.microbatches, schedule=args.schedule,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
