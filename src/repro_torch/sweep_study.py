"""Sweep study: a graph-family x framework x theta fleet in stacked batches.

Where ``quickstart`` refines ONE instance, this runs a whole scenario
fleet — three graph families x both cost frameworks x three hysteresis
levels — through the batched sweep runtime (``repro_torch.sweeps``,
DESIGN.md §12).  Cases sharing a group key (framework, N, K, theta on or
off) run as ONE batched loop, so the 18-cell grid below is four batched
runs instead of eighteen, and prints the per-cell load-CV / potential /
migration table the paper's statistical claims are about.

  PYTHONPATH=src python -m repro_torch.sweep_study            # on cuda
  PYTHONPATH=src python -m repro_torch.sweep_study --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import sweeps
from .core.problem import make_problem
from .graphs.generators import (preferential_attachment, random_degree_graph,
                                random_weights, specialized_geometric)

N, K, MU = 96, 4, 8.0
SPEEDS = (0.4, 0.3, 0.2, 0.1)
FAMILIES = {
    "random-degree": lambda seed: random_degree_graph(N, seed),
    "pref-attach": lambda seed: preferential_attachment(N, seed, m=2),
    "geometric": lambda seed: specialized_geometric(N, seed),
}
THETAS = {"theta=0": None, "theta=5": 5.0, "theta=20": 20.0}


def build_cases(device):
    cases = []
    for fi, (fname, gen) in enumerate(FAMILIES.items()):
        adj = gen(fi)
        node_w, edge_w = random_weights(adj, seed=100 + fi, mean=5.0)
        problem = make_problem(edge_w, node_w, SPEEDS, mu=MU, device=device)
        r0 = np.random.default_rng(fi).integers(0, K, N)
        for fw in ("c", "ct"):
            for tname, theta in THETAS.items():
                cases.append(sweeps.SweepCase(
                    problem=problem, assignment=r0, framework=fw,
                    theta=theta, label=f"{fname}/{fw}/{tname}"))
    return cases


def main(argv=None) -> sweeps.SweepResult:
    """Run the study; returns the :class:`~repro_torch.sweeps.SweepResult`."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cases = build_cases(args.device)
    spec = sweeps.make_spec(cases, mode="traced", max_turns=384)
    groups = {(c.framework, c.theta is None) for c in cases}
    print(f"{len(cases)} cells -> {len(groups)} batched runs "
          f"(grouped by framework x theta-presence)\n")
    result = sweeps.run_sweep(spec)

    header = ["cell", "moves", "load CV", "C_0", "Ct_0"]
    rows = [[s["label"], s["moves"], f"{s['load_cv']:.3f}",
             f"{s['c0']:.0f}", f"{s['ct0']:.0f}"]
            for s in result.summary()]
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(header)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*header))
    print(fmt.format(*["-" * w for w in widths]))
    for r in rows:
        print(fmt.format(*r))

    # the statistical read-off: hysteresis trades balance for stability,
    # uniformly across families and frameworks
    cv = result.load_cv()
    moves = result.moves
    for tname in THETAS:
        sel = [i for i, c in enumerate(cases) if c.label.endswith(tname)]
        print(f"\n{tname:>8}: mean load CV {cv[sel].mean():.3f}, "
              f"mean moves {moves[sel].mean():.1f}")
    return result


if __name__ == "__main__":
    main()
