"""Meta-heuristics for escaping poor local minima (paper §4.4 and §7),
PyTorch port of ``repro.core.annealing``.

  * ``simulated_annealing`` — Metropolis single-node moves over the chosen
    global potential with geometric cooling ([Kirkpatrick et al. 1983],
    cited in §4.4).  The paper reports ~5% cost improvements from annealing
    on comparable partitioning problems.
  * ``cluster_move_pass`` (in cluster.py) — the §7 "transfer groups of
    connected nodes" future-work idea.

The reference draws each step's proposal with threefry keys, which a
``torch.Generator`` cannot reproduce.  So the port draws every step's
(node, machine, coin) up front and runs the Metropolis chain over those
draws (:func:`_metropolis`); fed the reference's own draws, the chain makes
the reference's moves one for one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import costs
from .problem import as_assignment


class AnnealResult(NamedTuple):
    assignment: torch.Tensor
    cost: torch.Tensor
    accepted: torch.Tensor     # int32 — number of accepted proposals
    trace: torch.Tensor        # (steps,) potential after each proposal


def simulated_annealing(problem, assignment, generator: torch.Generator,
                        framework: str = costs.C_FRAMEWORK,
                        steps: int = 2048, t0: float = 100.0,
                        cooling: float = 0.995) -> AnnealResult:
    """Metropolis search over single-node reassignments.

    Proposal: uniform (node, machine), drawn from ``generator`` (a
    ``torch.Generator`` on the problem's device).  Accept if the potential
    decreases or with probability exp(-delta / T).  Tracks the best-so-far
    assignment so the output never regresses versus the input.
    """
    dev = problem.device
    nodes = torch.randint(0, problem.num_nodes, (steps,), generator=generator,
                          device=dev)
    dests = torch.randint(0, problem.num_machines, (steps,),
                          generator=generator, device=dev)
    coins = torch.rand((steps,), generator=generator, device=dev)
    return _metropolis(problem, assignment, nodes, dests, coins, framework,
                       t0, cooling)


def _metropolis(problem, assignment, nodes: torch.Tensor,
                dests: torch.Tensor, coins: torch.Tensor,
                framework: str = costs.C_FRAMEWORK, t0: float = 100.0,
                cooling: float = 0.995) -> AnnealResult:
    """The Metropolis chain over given draws: step s proposes moving
    ``nodes[s]`` to ``dests[s]`` and accepts an ascent when ``coins[s]``
    (uniform in [0, 1)) is below exp(-delta / T).  Nothing is read back
    to the host inside the chain."""
    dev = problem.device
    r = as_assignment(assignment, dev)
    nidx = torch.arange(problem.num_nodes, device=dev)
    cur = costs.global_cost(problem, r, framework)
    best_r, best_c = r, cur
    temp = torch.tensor(t0, dtype=torch.float32, device=dev)
    acc = torch.zeros((), dtype=torch.int32, device=dev)
    trace = []
    for s in range(nodes.shape[0]):
        cand = torch.where(nidx == nodes[s], dests[s].to(torch.int32), r)
        cand_cost = costs.global_cost(problem, cand, framework)
        delta = cand_cost - cur
        accept = (delta < 0) | (coins[s] < torch.exp(-delta / temp))
        r = torch.where(accept, cand, r)
        cur = torch.where(accept, cand_cost, cur)
        better = cur < best_c
        best_r = torch.where(better, r, best_r)
        best_c = torch.where(better, cur, best_c)
        acc = acc + accept.to(torch.int32)
        temp = temp * cooling
        trace.append(cur)
    trace = torch.stack(trace) if trace else torch.zeros(0, device=dev)
    return AnnealResult(assignment=best_r, cost=best_c, accepted=acc,
                        trace=trace)
