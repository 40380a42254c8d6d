"""Paper §6 end-to-end on the card: optimistic parallel DES with dynamic
repartitioning.

Runs the limited-scope flooded packet-flow workload (moving hot spots) on
the Time-Warp archetype twice — once with the initial partition only, once
with periodic game-theoretic refinement — and reports simulation execution
time, rollbacks and per-machine load balance (Figs. 7/9/10 in miniature).

  PYTHONPATH=src python -m repro_torch.des_partitioning            # on cuda
  PYTHONPATH=src python -m repro_torch.des_partitioning --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .core.initial import initial_partition
from .des.engine import DESConfig, make_initial_state, run_simulation
from .des.workload import flooded_packet_workload
from .graphs.generators import preferential_attachment


def simulate(adj: np.ndarray, refine_freq: int, device):
    n = adj.shape[0]
    spec = flooded_packet_workload(adj, seed=3, num_threads=16,
                                   num_windows=4, scope=2,
                                   window_sim_time=60.0, max_per_lp=3)
    deg = int((adj > 0).sum(1).max())
    cfg = DESConfig(num_lps=n, num_machines=4, num_threads=16,
                    event_capacity=max(48, 2 * deg + 8),
                    history_capacity=max(96, 4 * deg + 16),
                    inter_delay=8, intra_delay=1,
                    refine_freq=refine_freq, trace_stride=25,
                    max_ticks=100_000)
    adj_t = torch.as_tensor(adj, device=device)
    m0 = initial_partition(adj_t, 4, generator=1)
    state = make_initial_state(cfg, m0, spec.src, spec.time, spec.count,
                               device=device)
    return run_simulation(cfg, adj_t, state)


def main(argv=None) -> float:
    """Run both simulations; returns the relative change in sim time."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    adj = preferential_attachment(64, seed=2, m=2)
    static = simulate(adj, refine_freq=0, device=args.device)
    dynamic = simulate(adj, refine_freq=400, device=args.device)
    for name, out in (("static partition ", static),
                      ("refine @400 ticks", dynamic)):
        tr = out.trace[:int(out.trace_ptr)].cpu().numpy()
        active = tr.mean(1) > 1e-6
        cv = float(np.mean(tr[active].std(1)
                           / np.maximum(tr[active].mean(1), 1e-6))) \
            if active.any() else 0.0
        print(f"{name}: sim time = {int(out.tick):6d} ticks   "
              f"rollbacks = {int(out.rollbacks):5d}   "
              f"refines = {int(out.refines):2d}   "
              f"migrations = {int(out.moves):3d}   load CV = {cv:.3f}")
    change = (int(static.tick) - int(dynamic.tick)) / int(static.tick)
    print(f"\ndynamic repartitioning changed simulation time by "
          f"{100 * change:+.1f}% (paper Figs. 7/8: faster with frequent "
          f"refinement)")
    return change


if __name__ == "__main__":
    main()
