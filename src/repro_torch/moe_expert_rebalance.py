"""The paper's technique as a production feature: dynamic MoE expert
placement from live router statistics (DESIGN.md §4; port of
``examples/moe_expert_rebalance.py``).

Trains a small MoE whose data distribution SHIFTS mid-run (token
distribution change => router load shifts => expert hot spots move —
exactly the paper's 'moving hot spot' scenario, §6.1).  The partition
planner replans the expert→device-group assignment every 15 steps and we
print the weighted load imbalance before/after each replan.  Runs on the
card unless ``--device cpu``: kernel 7 in every attention layer's
forward, kernel 1 in every refinement turn of a replan.

  PYTHONPATH=src python -m repro_torch.moe_expert_rebalance
  PYTHONPATH=src python -m repro_torch.moe_expert_rebalance --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.sharding.planner import PartitionPlanner
from repro_torch.training.data import SyntheticDataConfig, synthetic_batch
from repro_torch.training.train_step import (TrainHyper, init_train_state,
                                             make_train_step)

ARCH = "qwen3-moe-235b-a22b"     # its smoke config: 8 experts, top-2
STEPS = 60


def run(state=None, *, steps: int = STEPS, device: str = "cuda",
        verbose: bool = True):
    """The example's loop from ``state`` (default: ``init_train_state``
    from seed 0 on ``device``).  Returns (final state, records): one record
    a replan with its step, the loss of that step, the planner's stats,
    the permutation it applied (None when no expert moved), and the router
    statistics it replanned from (CPU copies)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke_config(ARCH)
    hyper = TrainHyper(total_steps=steps, warmup=5)
    step = make_train_step(cfg, hyper)
    if state is None:
        state = init_train_state(cfg, 0, device=device)
    planner = PartitionPlanner(num_groups=4, interval=15, mu=0.5)

    data_a = SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=8, zipf_a=1.4, seed=0)
    data_b = dataclasses.replace(data_a, zipf_a=0.6, seed=7)  # the shift

    records = []
    for i in range(steps):
        data = data_a if i < steps // 2 else data_b
        state, metrics = step(state, synthetic_batch(data, i, device=device))
        if i == steps // 2 and verbose:
            print(f"--- step {i}: data distribution shift (hot spot moves)")
        if (i + 1) % planner.interval == 0:
            load, coact = state.expert_load.cpu(), state.coactivation.cpu()
            planner._last_perm = None
        state, stats = planner.maybe_replan(i + 1, state)
        if stats:
            perm = planner._last_perm
            records.append({"step": i + 1, "loss": float(metrics["loss"]),
                            "stats": stats, "expert_load": load,
                            "coactivation": coact,
                            "perm": None if perm is None else perm.cpu()})
            if verbose:
                print(f"step {i + 1:3d}  loss={float(metrics['loss']):.3f}  "
                      f"expert imbalance {stats['imbalance_before']:.2f} -> "
                      f"{stats['imbalance_after']:.2f}  "
                      f"({stats['moves']} game moves)")
    if verbose:
        load = state.expert_load.cpu().numpy()
        print(f"\nfinal EMA expert load (top 4): "
              f"{np.sort(load)[::-1][:4].round(3)}")
    return state, records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
