"""Quickstart on the card: the paper's game-theoretic partitioner.

Builds the §5.1 setup (230 LPs, 5 machines of unequal speed, mu=8), runs
Appendix-A initial partitioning and best-response refinement, and prints
the potential descent and the equilibrium check.

  PYTHONPATH=src python -m repro_torch.quickstart            # on cuda
  PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from .core import costs
from .core.initial import initial_partition
from .core.problem import machine_loads, make_problem, make_state
from .core.refine import refine
from .graphs.generators import random_degree_graph, random_weights


def main(argv=None) -> float:
    """Run the quickstart; returns the max dissatisfaction at the end."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the network model under simulation: a random graph of LPs
    adj = random_degree_graph(230, seed=0, dmin=3, dmax=6)
    node_w, edge_w = random_weights(adj, seed=1, mean=5.0)

    # 2. the partition game: 5 machines with speeds (0.1..0.3), mu = 8
    problem = make_problem(edge_w, node_w, speeds=[0.1, 0.2, 0.3, 0.3, 0.1],
                           mu=8.0, device=args.device)

    # 3. Appendix-A initial partition: focal nodes + hop-by-hop expansion
    r0 = initial_partition(problem.adjacency, 5, generator=0)
    print(f"initial  C_0 = {float(costs.global_cost_c0(problem, r0)):12.0f}"
          f"   Ct_0 = {float(costs.global_cost_ct0(problem, r0)):10.0f}")

    # 4. iterative refinement: machines take turns moving their most
    #    dissatisfied node to its best-response machine (Thm 4.1 descent)
    result = refine(problem, r0, framework="c")
    r = result.assignment
    print(f"refined  C_0 = {float(costs.global_cost_c0(problem, r)):12.0f}"
          f"   Ct_0 = {float(costs.global_cost_ct0(problem, r)):10.0f}   "
          f"({int(result.num_moves)} node transfers, "
          f"converged={bool(result.converged)})")

    # 5. Nash check: at the equilibrium no LP can improve unilaterally
    dis, _ = costs.dissatisfaction(problem, make_state(problem, r), "c")
    worst = float(torch.max(dis))
    print(f"max dissatisfaction at equilibrium: {worst:.2e} (Eq. 3 holds)")
    loads = machine_loads(problem.node_weights, r, 5) / problem.speeds
    print("weighted machine loads:", [f"{float(x):.0f}" for x in loads])
    return worst


if __name__ == "__main__":
    main()
