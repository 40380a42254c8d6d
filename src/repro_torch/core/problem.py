"""Partition-game problem container (PyTorch port of ``repro.core.problem``).

The paper partitions an undirected weighted graph G = (V, E) of logical
processes among K machines.  ``PartitionProblem`` carries everything the
two cost frameworks (Eq. 1 and Eq. 6) need:

  * ``adjacency``    — dense symmetric (N, N) float32 tensor of edge
                       weights ``c_ij`` (zero diagonal).
  * ``node_weights`` — (N,) computational load ``b_i`` per LP.
  * ``speeds``       — (K,) normalized machine capacities ``w_k`` (sum 1).
  * ``mu``           — 0-d tensor, the relative weight of the inter-machine
                       rollback-delay cost (paper §3.1).

Every tensor of a problem lives on one device.  Builders default to
``cuda``; pass ``device="cpu"`` to run on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


class ProblemValidationError(ValueError):
    """Typed error for malformed problem inputs (DESIGN.md §15.7)."""


def resolve_device(device) -> torch.device:
    """``None`` means the card; anything else is taken as given."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


@dataclasses.dataclass(frozen=True)
class PartitionProblem:
    adjacency: torch.Tensor      # (N, N) float32, symmetric, zero diagonal
    node_weights: torch.Tensor   # (N,)  float32
    speeds: torch.Tensor         # (K,)  float32, sums to 1
    mu: torch.Tensor             # ()    float32

    @property
    def num_nodes(self) -> int:
        return self.adjacency.shape[0]

    @property
    def num_machines(self) -> int:
        return self.speeds.shape[0]

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    def validate(self) -> None:
        """Raise :class:`ProblemValidationError` on malformed fields."""
        n = self.num_nodes
        if self.adjacency.ndim != 2 or self.adjacency.shape != (n, n):
            raise ProblemValidationError(
                f"adjacency must be square (N, N); got "
                f"{tuple(self.adjacency.shape)}")
        if tuple(self.node_weights.shape) != (n,):
            raise ProblemValidationError(
                f"node_weights shape {tuple(self.node_weights.shape)} does "
                f"not match N={n}")
        if self.speeds.ndim != 1:
            raise ProblemValidationError(
                f"speeds must be (K,); got shape {tuple(self.speeds.shape)}")
        adj = self.adjacency
        if bool(torch.isnan(adj).any()):
            raise ProblemValidationError("adjacency contains NaN edge "
                                         "weights")
        if bool((adj < 0).any()):
            raise ProblemValidationError("adjacency contains negative edge "
                                         "weights")
        if not torch.equal(adj, adj.T):
            raise ProblemValidationError("adjacency is not symmetric (the "
                                         "graph is undirected; use "
                                         "make_problem to symmetrize)")
        b = self.node_weights
        if bool(torch.isnan(b).any()) or bool((b < 0).any()):
            raise ProblemValidationError("node_weights must be finite and "
                                         "non-negative")
        w = self.speeds
        if bool(torch.isnan(w).any()) or bool((w <= 0).any()):
            raise ProblemValidationError("speeds must be finite and "
                                         "positive")


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def make_problem(adjacency, node_weights, speeds, mu: float = 8.0, *,
                 normalize_speeds: bool = True,
                 device=None) -> PartitionProblem:
    """Build a :class:`PartitionProblem`, symmetrizing and normalizing inputs."""
    device = resolve_device(device)
    adjacency = _f32(adjacency, device)
    # Symmetrize and clear the diagonal: the paper's graph is undirected and
    # self-edges are meaningless for a cut.
    adjacency = 0.5 * (adjacency + adjacency.T)
    adjacency = adjacency * (1.0 - torch.eye(adjacency.shape[0],
                                             dtype=torch.float32,
                                             device=device))
    node_weights = _f32(node_weights, device)
    speeds = _f32(speeds, device)
    if normalize_speeds:
        speeds = speeds / torch.sum(speeds)
    prob = PartitionProblem(adjacency, node_weights, speeds,
                            torch.tensor(mu, dtype=torch.float32,
                                         device=device))
    prob.validate()
    return prob


def problem_from_arrays(adjacency, node_weights, speeds, mu,
                        device=None) -> PartitionProblem:
    """Carry an already-built problem across: the fields are taken as they
    are (already symmetrized, zero-diagonal and speed-normalized), so two
    implementations fed the same arrays compute on identical bits.
    ``make_problem`` stays the user-facing builder."""
    device = resolve_device(device)
    prob = PartitionProblem(_f32(adjacency, device),
                            _f32(node_weights, device),
                            _f32(speeds, device),
                            _f32(mu, device).reshape(()))
    prob.validate()
    return prob


@dataclasses.dataclass(frozen=True)
class PartitionState:
    """Assignment vector plus the machine-level aggregate the paper exchanges.

    ``loads`` is the only *global* state a machine needs (paper §4.5): the
    per-machine sums ``L_k = sum_{j: r_j = k} b_j``.
    """
    assignment: torch.Tensor  # (N,) int32 in [0, K)
    loads: torch.Tensor       # (K,) float32

    @property
    def num_machines(self) -> int:
        return self.loads.shape[0]


def validate_assignment(assignment, num_machines: int,
                        num_nodes: int | None = None) -> None:
    """Raise :class:`ProblemValidationError` on a malformed assignment
    vector: wrong dtype/shape, or machine ids outside ``[0, num_machines)``."""
    if getattr(assignment, "ndim", None) != 1:
        raise ProblemValidationError(
            f"assignment must be a 1-D vector; got "
            f"{getattr(assignment, 'shape', type(assignment))}")
    dtype = assignment.dtype
    if isinstance(dtype, torch.dtype):
        integer = not dtype.is_floating_point and dtype != torch.bool
    else:
        integer = np.issubdtype(dtype, np.integer)
    if not integer:
        raise ProblemValidationError(
            f"assignment must be integer-typed; got {dtype}")
    if num_nodes is not None and assignment.shape[0] != num_nodes:
        raise ProblemValidationError(
            f"assignment has {assignment.shape[0]} entries for "
            f"{num_nodes} nodes")
    if assignment.shape[0]:
        lo, hi = int(assignment.min()), int(assignment.max())
        if lo < 0 or hi >= num_machines:
            raise ProblemValidationError(
                f"assignment entries must lie in [0, {num_machines}); got "
                f"range [{lo}, {hi}]")


def as_assignment(assignment, device) -> torch.Tensor:
    """An int32 assignment tensor on ``device``."""
    if isinstance(assignment, torch.Tensor):
        return assignment.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.array(assignment, dtype=np.int32),
                           device=device)


def machine_loads(node_weights: torch.Tensor, assignment: torch.Tensor,
                  num_machines: int) -> torch.Tensor:
    """L_k = sum of b_j over nodes assigned to machine k.

    A one-hot product in full float32 rather than ``index_add_``: on the
    card ``index_add_`` sums with atomics, in an order that changes from
    run to run.
    """
    onehot = (assignment.long()[:, None]
              == torch.arange(num_machines, device=assignment.device)
              ).to(node_weights.dtype)
    return node_weights @ onehot


def make_state(problem: PartitionProblem, assignment) -> PartitionState:
    assignment = as_assignment(assignment, problem.device)
    loads = machine_loads(problem.node_weights, assignment,
                          problem.num_machines)
    return PartitionState(assignment=assignment, loads=loads)
