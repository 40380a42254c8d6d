"""The paper's two node-level cost frameworks and their global potentials
(PyTorch port of ``repro.core.costs``, dense arms).

Framework 1 (Eq. 1):
    C_i(r) = (b_i / w_{r_i}) * sum_{j != i, r_j = r_i} b_j
             + (mu/2) * sum_{j: r_j != r_i} c_ij
  Global potential (Thm. 3.1):  C_0(r) = sum_i C_i(r), with
  Delta C_0 = 2 * Delta C_l for a unilateral move of node l.

Framework 2 (Eq. 6):
    Ct_i(r) = b_i^2/w_{r_i}^2 + (2 b_i / w_{r_i}^2) * sum_{j != i, r_j=r_i} b_j
              - (2 b_i / w_{r_i}) * B + (mu/2) * sum_{j: r_j != r_i} c_ij
  Global objective (Eq. 8):  Ct_0(r) = sum_k (L_k / w_k - B)^2 + (mu/2) cut(r),
  with Delta Ct_0 = Delta Ct_l (Thm. 5.1).  The (mu/2) * unordered-cut
  convention is the one of DESIGN.md §8.

Every formula keeps the reference's order of operations, so the same
inputs round the same way.

Sparse problems (DESIGN.md §13): every entry point taking a ``problem``
also takes a :class:`~repro_torch.core.sparse.SparseProblem` — the
aggregate becomes an O(E) window-by-window sum over the edge list
(:func:`adjacency_aggregate_sparse`), the cut an O(E) edge sum
(:func:`total_cut_sparse`), and C_0 the O(K) closed form of
:func:`potentials_closed_form`.  Anything that is neither kind of
problem raises ``TypeError``.
"""
from __future__ import annotations

import torch

from .problem import PartitionProblem, PartitionState, machine_loads
from .sparse import SparseProblem, window_slots

C_FRAMEWORK = "c"     # Eq. 1
CT_FRAMEWORK = "ct"   # Eq. 6
FRAMEWORKS = (C_FRAMEWORK, CT_FRAMEWORK)

# Declared asymptotic budgets for the dense representation, consumed by
# the complexity analyzers (``repro_torch.analysis``, DESIGN.md §18).
# Exponent caps per problem dimension: the (N, N) adjacency is the
# representation floor, so dense paths may produce O(N^2) intermediates
# and O(N^2 * K) work — anything steeper is a finding.
DENSE_COMPLEXITY = {
    "mem": {"n": 2.0, "k": 1.0},
    "ops": {"n": 2.0, "k": 1.0},
}


def is_sparse(problem) -> bool:
    """True for a :class:`SparseProblem`, False for a dense
    :class:`PartitionProblem`; ``TypeError`` for anything else."""
    if isinstance(problem, SparseProblem):
        return True
    if isinstance(problem, PartitionProblem):
        return False
    raise TypeError(f"expected a PartitionProblem or a SparseProblem; got "
                    f"{type(problem).__name__}")


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed order, k ascending, keeping the
    axis: the order the card's kernels use, so all paths round alike."""
    total = x[..., 0:1]
    for k in range(1, x.shape[-1]):
        total = total + x[..., k:k + 1]
    return total


def one_hot(assignment: torch.Tensor, num_machines: int,
            dtype=torch.float32) -> torch.Tensor:
    kidx = torch.arange(num_machines, device=assignment.device)
    return (assignment.long()[..., None] == kidx).to(dtype)


def per_element(x, trailing: int):
    """A per-element scalar of a stacked fleet, a (B,) tensor, shaped to
    broadcast against (B, ..., rows, K) blocks by ``trailing`` singleton
    axes.  A 0-d tensor or a Python number passes through unchanged, so
    one formula serves a single problem and a stack (DESIGN.md §12)."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x.reshape(x.shape + (1,) * trailing)
    return x


def adjacency_aggregate(adjacency: torch.Tensor, assignment: torch.Tensor,
                        num_machines: int) -> torch.Tensor:
    """A[i, k] = sum_j c_ij * 1[r_j = k]; computed as C @ one_hot(r) in
    full float32 (TF32 is off on every compared path)."""
    return adjacency @ one_hot(assignment, num_machines, adjacency.dtype)


def adjacency_aggregate_sparse(sp: SparseProblem,
                               assignment: torch.Tensor) -> torch.Tensor:
    """The same (N, K) aggregate from the edge list, O(E).

    Each (row, machine) slot sums its row's edges in ascending edge
    order (receivers ascending), starting from 0 — the order of the
    reference's ``segment_sum`` over the flat ``sender * K + r[receiver]``
    slot id, so the values are bitwise equal.  The sum runs one window
    slot at a time (:func:`~repro_torch.core.sparse.window_slots`): each
    step adds at most one edge to each row, so the writes never collide
    and no atomics are needed; masked slots add an exact ``+0.0``.
    """
    n, k = sp.num_nodes, sp.num_machines
    flat = torch.zeros(n * k, dtype=sp.edge_weights.dtype, device=sp.device)
    base = torch.arange(n, device=sp.device) * k
    a = assignment.long()
    for e, own in window_slots(sp):
        w = torch.where(own, sp.edge_weights.index_select(0, e), 0.0)
        pos = base + a.index_select(0, sp.receivers.index_select(0, e)
                                    .long())
        flat[pos] = flat.index_select(0, pos) + w
    return flat.view(n, k)


def problem_aggregate(problem, assignment: torch.Tensor,
                      num_machines: int) -> torch.Tensor:
    """Build the (N, K) aggregate for either problem representation."""
    if is_sparse(problem):
        return adjacency_aggregate_sparse(problem, assignment)
    return adjacency_aggregate(problem.adjacency, assignment, num_machines)


def cut_matrix(adjacency: torch.Tensor, assignment: torch.Tensor,
               num_machines: int,
               aggregate: torch.Tensor | None = None) -> torch.Tensor:
    """cut[i, k] = sum_{j: r_j != k} c_ij  (the mu/2 factor applied later)."""
    if aggregate is None:
        aggregate = adjacency_aggregate(adjacency, assignment, num_machines)
    return row_sum(aggregate) - aggregate


def cost_matrix_from_aggregate(aggregate: torch.Tensor,
                               row_assignment: torch.Tensor,
                               node_weights: torch.Tensor,
                               loads: torch.Tensor, speeds: torch.Tensor,
                               mu: torch.Tensor, framework: str,
                               total_weight: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """O(rows*K) cost assembly from an already-built adjacency aggregate —
    the one shared cost formula (DESIGN.md §10).

    ``aggregate`` is the (rows, K) block A[i, k] = sum_j c_ij 1[r_j = k];
    ``row_assignment`` gives the rows' OWN machines; ``total_weight`` is
    the global weight sum B, required by the Ct framework (defaults to
    ``sum(node_weights)``, correct only when the rows are the full graph).

    A fleet (DESIGN.md §12) passes every operand with a leading batch
    axis — aggregate (B, rows, K), rows (B, rows), loads and speeds
    (B, K), ``mu`` and ``total_weight`` (B,) — and gets (B, rows, K):
    the same elementwise ops, so each element is bitwise its own call.
    """
    b = node_weights
    k = loads.shape[-1]
    degree = row_sum(aggregate)                                # = sum_j c_ij
    cut_term = 0.5 * per_element(mu, 2) * (degree - aggregate)
    own = one_hot(row_assignment, k, b.dtype)                  # (rows, K)
    # node i's weight is subtracted only on its CURRENT machine — every
    # other machine's load already excludes i.
    others = loads[..., None, :] - b[..., :, None] * own
    if framework == C_FRAMEWORK:
        load_term = (b[..., :, None] / speeds[..., None, :]) * others
        return load_term + cut_term
    if framework == CT_FRAMEWORK:
        if total_weight is None:
            total_weight = torch.sum(b)
        inv_w = 1.0 / speeds[..., None, :]
        inv_w2 = inv_w * inv_w
        bcol = b[..., :, None]
        load_term = (bcol * bcol) * inv_w2 \
            + 2.0 * bcol * inv_w2 * others \
            - 2.0 * bcol * inv_w * per_element(total_weight, 2)
        return load_term + cut_term
    raise ValueError(f"unknown framework {framework!r}")


def cost_matrix(problem, state: PartitionState,
                framework: str = C_FRAMEWORK,
                aggregate: torch.Tensor | None = None) -> torch.Tensor:
    """(N, K) matrix of node costs: entry [i, k] = cost of node i if on
    machine k (column r_i is the node's current cost)."""
    k = problem.num_machines
    if aggregate is None:
        aggregate = problem_aggregate(problem, state.assignment, k)
    return cost_matrix_from_aggregate(
        aggregate, state.assignment, problem.node_weights, state.loads,
        problem.speeds, problem.mu, framework,
        total_weight=torch.sum(problem.node_weights))


def node_costs(problem, state: PartitionState,
               framework: str = C_FRAMEWORK) -> torch.Tensor:
    """(N,) current cost of every node under its current assignment."""
    cm = cost_matrix(problem, state, framework)
    return cm.gather(1, state.assignment.long()[:, None])[:, 0]


def dissatisfaction_from_cost(cost: torch.Tensor,
                              row_assignment: torch.Tensor,
                              theta: torch.Tensor | None = None):
    """Eq. 4 from an already-assembled cost block: I(i) and the arg-best
    machine, ties toward the lowest machine index (DESIGN.md §7).

    The returned dissatisfaction is net of the per-node migration price
    ``theta`` (DESIGN.md §11); this is the one place it is subtracted
    outside the kernels.  ``current`` (a gather) and ``best`` (a min) read
    the same materialized tensor, so a node on its best machine gets
    exactly 0.  A fleet's (B, rows, K) block works the same over its
    last axis.
    """
    current = cost.gather(-1, row_assignment.long()[..., None])[..., 0]
    best = torch.min(cost, dim=-1).values
    k = cost.shape[-1]
    kidx = torch.arange(k, device=cost.device)
    best_machine = torch.where(cost <= best[..., None], kidx,
                               k).min(dim=-1).values
    dissat = current - best
    if theta is not None:
        dissat = dissat - theta
    return dissat, best_machine.to(torch.int32)


def dissatisfaction(problem, state: PartitionState,
                    framework: str = C_FRAMEWORK,
                    cost: torch.Tensor | None = None,
                    theta: torch.Tensor | None = None):
    """Eq. 4:  I(i) = C_i(r_i) - min_k C_i(k), with the arg-best machine."""
    if cost is None:
        cost = cost_matrix(problem, state, framework)
    return dissatisfaction_from_cost(cost, state.assignment, theta)


# ---------------------------------------------------------------------------
# Global potentials
# ---------------------------------------------------------------------------

def total_cut(adjacency: torch.Tensor, assignment: torch.Tensor
              ) -> torch.Tensor:
    """Unordered cut weight: (1/2) sum_{i,j} c_ij 1[r_i != r_j]."""
    diff = assignment[:, None] != assignment[None, :]
    return 0.5 * torch.sum(adjacency * diff)


def total_cut_sparse(sp: SparseProblem,
                     assignment: torch.Tensor) -> torch.Tensor:
    """Unordered cut from the edge list — O(E).  Each undirected edge is
    stored in both directions, so the directed crossings are halved;
    padded edges (weight 0) add exactly 0."""
    a = assignment.long()
    crossing = a[sp.senders.long()] != a[sp.receivers.long()]
    return 0.5 * torch.sum(torch.where(crossing, sp.edge_weights, 0.0))


def problem_cut(problem, assignment: torch.Tensor) -> torch.Tensor:
    """Unordered cut for either problem representation."""
    if is_sparse(problem):
        return total_cut_sparse(problem, assignment)
    return total_cut(problem.adjacency, assignment)


def potentials_closed_form(loads, sq_loads, cut, speeds, mu, total_weight):
    """(C_0, Ct_0) as O(K) closed forms of machine-level sums.

    C_0 = sum_k (L_k^2 - S_k)/w_k + mu * cut, with S_k = sum_{i on k}
    b_i^2; Ct_0 = sum_k (L_k/w_k - B)^2 + mu/2 * cut (Eq. 8).
    """
    c0 = torch.sum((loads * loads - sq_loads) / speeds) + mu * cut
    dev = loads / speeds - total_weight
    ct0 = torch.sum(dev * dev) + 0.5 * mu * cut
    return c0, ct0


def global_cost_c0(problem, assignment: torch.Tensor) -> torch.Tensor:
    """C_0(r) = sum_i C_i(r)  (Thm. 3.1 potential, social welfare).

    Sparse problems evaluate the O(K) closed form over (loads, sq_loads,
    cut) instead of summing N node costs — the same value up to f32
    reassociation (DESIGN.md §13.3)."""
    sparse = is_sparse(problem)
    b = problem.node_weights
    if sparse:
        k = problem.num_machines
        loads = machine_loads(b, assignment, k)
        sq_loads = machine_loads(b * b, assignment, k)
        cut = total_cut_sparse(problem, assignment)
        return potentials_closed_form(loads, sq_loads, cut, problem.speeds,
                                      problem.mu, torch.sum(b))[0]
    state = PartitionState(assignment,
                           machine_loads(b, assignment,
                                         problem.num_machines))
    return torch.sum(node_costs(problem, state, C_FRAMEWORK))


def global_cost_ct0(problem, assignment: torch.Tensor) -> torch.Tensor:
    """Ct_0(r) = sum_k (L_k / w_k - B)^2 + (mu/2) cut(r)  (Eq. 8)."""
    b = problem.node_weights
    loads = machine_loads(b, assignment, problem.num_machines)
    total = torch.sum(b)
    dev = loads / problem.speeds - total
    return torch.sum(dev * dev) + 0.5 * problem.mu * problem_cut(problem,
                                                                 assignment)


def global_cost(problem, assignment: torch.Tensor,
                framework: str) -> torch.Tensor:
    if framework == C_FRAMEWORK:
        return global_cost_c0(problem, assignment)
    if framework == CT_FRAMEWORK:
        return global_cost_ct0(problem, assignment)
    raise ValueError(f"unknown framework {framework!r}")


def load_imbalance(problem, assignment: torch.Tensor) -> torch.Tensor:
    """max_k L_k/w_k divided by B — 1.0 means perfectly balanced."""
    loads = machine_loads(problem.node_weights, assignment,
                          problem.num_machines)
    total = torch.sum(problem.node_weights)
    return torch.max(loads / problem.speeds) / total
