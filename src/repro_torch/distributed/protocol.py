"""The O(K) aggregate-exchange protocol (DESIGN.md §9.2), PyTorch port of
``repro.distributed.protocol``.

Per sequential turn (acting machine m), each shard ships exactly one
:class:`Candidate` — 16 bytes: its most dissatisfied m-owned node, that
node's best-response machine, the dissatisfaction gain, and the node's
weight.  The all-gather of these S candidates *is* the entire inter-machine
exchange of the turn; every machine then runs the same deterministic
:func:`elect` on the gathered array and applies the same
:func:`apply_move` delta to its replicated assignment mirror and O(K) load
vector.  No O(N) state crosses the wire after the one-time O(boundary)
ghost sync (see :mod:`~repro_torch.distributed.views`).

Shard-local compute is **incremental** (DESIGN.md §10): each shard carries
its (Ns, K) row-block aggregate and applies the elected move as a rank-1
column update (:func:`update_block_aggregate`).  The emulated drivers hold
all S blocks as one (S, Ns, K) stack, so one reduction (kernel 3 on the
card) serves every shard of a turn; the functions below take such stacks
(the collective driver passes a stack of one, its own block).

Traced runs additionally exchange, per candidate, the two
exact-potential-identity deltas (ΔC_0, ΔCt_0 — Thm. 3.1/5.1), 8 bytes.
The hysteresis threshold ``theta`` (DESIGN.md §11) is a shard-local input:
each shard subtracts its own slice before picking its candidate.

Numerical contract, within the port: every value a turn decides on is
bitwise the single controller's (:mod:`repro_torch.core.refine`).  The
block aggregates are the rows of the controller's own aggregate product
(:func:`block_aggregates`), not a product per row block: a library
product may round a (Ns, N) block differently from the (N, N) whole.
The rank-1 and rank-K updates, the loads delta and the assignment write
repeat the controller's operations (``core/aggregate.py``: ``apply_move``,
``apply_sweep``'s ordered column adds, which use no float atomics).
:func:`elect` reproduces the global first-maximum tie-break: each shard's
argmax already picked its lowest-id maximizer, and shard blocks are
contiguous ascending id ranges.  ``max`` and ``argmax`` propagate NaN as
``jnp``'s do, which the fault layer's corrupt plans rely on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import aggregate as agg_mod
from ..core import costs
from ..core.problem import machine_loads
from .views import pad_rows

I32_MAX = 2**31 - 1

# Wire sizes (bytes) of the protocol messages, for the accounting ledgers.
CANDIDATE_BYTES = 16          # gain f32 + node i32 + dest i32 + weight f32
TRACE_PARTIAL_BYTES = 8       # ΔC_0 f32 + ΔCt_0 f32 per traced candidate


def load_partial_bytes(num_machines: int) -> int:
    """Fresh O(K) load partial exchanged per shard per §4.5 sweep."""
    return 4 * num_machines


class Candidate(NamedTuple):
    """Shards' proposals for the acting machine's move, 16 bytes each:
    (S,) tensors for one turn, (S, K) for a §4.5 sweep."""
    gain: torch.Tensor     # f32 — dissatisfaction of the proposed node
                           #       (-inf if the shard holds no movable
                           #       node for machine m)
    node: torch.Tensor     # i32 — global node id
    dest: torch.Tensor     # i32 — the node's best-response machine
    weight: torch.Tensor   # f32 — b_node (lets every peer update loads)


class Winner(NamedTuple):
    """Deterministic election result, identical on every machine: (1,)
    tensors for one turn, (K,) for a sweep."""
    moved: torch.Tensor    # bool — gain > tol
    node: torch.Tensor     # i32
    dest: torch.Tensor     # i32
    gain: torch.Tensor     # f32
    weight: torch.Tensor   # f32
    shard: torch.Tensor    # int64 — the winning candidate's shard (lets
                           #         traced callers pick that shard's
                           #         potential deltas)


# ---------------------------------------------------------------------------
# Shard-local compute (no communication)
# ---------------------------------------------------------------------------

def block_aggregates(problem, assignment: torch.Tensor,
                     num_shards: int) -> torch.Tensor:
    """(S, Ns, K) row-block aggregates: the rows of the controller's own
    (N, K) product (``costs.problem_aggregate``), padded with zero rows —
    bitwise the controller's aggregate rows by construction."""
    agg = costs.problem_aggregate(problem, assignment, problem.num_machines)
    return pad_rows(agg, num_shards).contiguous()


def block_aggregate(row_block: torch.Tensor, assignment: torch.Tensor,
                    num_machines: int) -> torch.Tensor:
    """One block's (Ns, K) aggregate from its own rows: A_s = rows @
    one_hot(r) — what a rank that holds only its rows computes."""
    return row_block @ costs.one_hot(assignment, num_machines,
                                     row_block.dtype)


def move_delta(num_machines: int, source, dest: torch.Tensor,
               moved: torch.Tensor, dtype, device) -> torch.Tensor:
    """The (K,) ``±1`` column delta of a move from ``source`` to ``dest``
    (a (1,) tensor), zeroed when ``moved`` is false — the controller's
    ``col_delta`` (``core.aggregate.apply_move``)."""
    kidx = torch.arange(num_machines, device=device)
    dest = dest.clamp(max=num_machines - 1)
    delta = (kidx == dest).to(dtype) - (kidx == source).to(dtype)
    return torch.where(moved, delta, 0.0)


def update_block_aggregate(aggregate: torch.Tensor, rows: torch.Tensor,
                           node: torch.Tensor,
                           col_delta: torch.Tensor) -> torch.Tensor:
    """Apply the elected move's rank-1 column update to (rows, K) blocks
    (``rows`` their (rows, N) adjacency): ``A += c[:, l] ⊗ delta``, the
    controller's update restricted to the shard's rows — O(Ns), no
    communication (every shard holds column l of its own row block)."""
    col = rows.index_select(1, node.long().reshape(1))   # (rows, 1)
    return aggregate + col * col_delta[None, :]


def update_block_aggregate_sweep(aggregate: torch.Tensor, rows: torch.Tensor,
                                 picks: torch.Tensor, dests: torch.Tensor,
                                 moved: torch.Tensor) -> torch.Tensor:
    """§4.5 rank-K block update: machine m's move of node picks[m] (owned
    by m, so source column = m) to dests[m], for all moving machines at
    once — ``core.aggregate.apply_sweep`` restricted to the shard's rows:
    the sources subtracted, then each destination added one column at a
    time in machine order (duplicate destinations sum in that order; no
    float atomics).  Idle machines' columns are masked to exact zero."""
    k = moved.shape[0]
    dt = aggregate.dtype
    mask = moved.to(dt)
    kidx = torch.arange(k, device=aggregate.device)
    dest_hot = (dests.long()[:, None] == kidx[None, :]).to(dt)  # (K, K)
    cols = rows.index_select(1, picks.long()) * mask[None, :]  # (rows, K)
    new = aggregate - cols
    for m in range(k):
        new = new + cols[:, m:m + 1] * dest_hot[m][None, :]
    return new


def shard_cost_from_aggregate(aggregate, r_local, b_local, loads, speeds, mu,
                              total_b, framework: str) -> torch.Tensor:
    """(rows, K) cost rows from carried block aggregates — O(rows*K), the
    controller's shared assembly (``costs.cost_matrix_from_aggregate``)."""
    return costs.cost_matrix_from_aggregate(
        aggregate, r_local, b_local, loads, speeds, mu, framework,
        total_weight=total_b)


def local_candidates(dissat: torch.Tensor, best: torch.Tensor,
                     r_local: torch.Tensor, weights: torch.Tensor,
                     ids: torch.Tensor, valid: torch.Tensor,
                     machine: int):
    """Every shard's most dissatisfied node owned by ``machine`` (Eq. 4),
    from its (S, Ns) ``dissat``/``best``: one (S,) Candidate, and the
    (S, 1) rows it came from."""
    owned = (r_local == machine) & valid
    masked = torch.where(owned, dissat, -float("inf"))
    loc = torch.argmax(masked, dim=1, keepdim=True)          # (S, 1)
    return Candidate(gain=masked.gather(1, loc)[:, 0],
                     node=ids.gather(1, loc)[:, 0],
                     dest=best.gather(1, loc)[:, 0],
                     weight=weights.gather(1, loc)[:, 0]), loc


def local_candidates_all_machines(dissat, best, r_local, weights, ids, valid,
                                  num_machines: int) -> Candidate:
    """§4.5 sweep candidates: each shard's most dissatisfied node of every
    machine — a Candidate of (S, K) tensors."""
    kidx = torch.arange(num_machines, device=dissat.device)
    owned = valid[:, None, :] & (r_local[:, None, :] == kidx[None, :, None])
    masked = torch.where(owned, dissat[:, None, :], -float("inf"))  # S,K,Ns
    loc = torch.argmax(masked, dim=2, keepdim=True)                 # S,K,1

    def at(x):
        return x[:, None, :].expand_as(masked).gather(2, loc)[..., 0]
    return Candidate(gain=masked.gather(2, loc)[..., 0], node=at(ids),
                     dest=at(best), weight=at(weights))


def candidate_deltas(aggregate, cands: Candidate, loc_rows: torch.Tensor,
                     machine: int, loads, speeds, mu, total_b):
    """(S,) ΔC_0 and ΔCt_0 of every shard's PROPOSED move via the
    exact-potential identities, from each candidate's aggregate row —
    O(K) a shard (``core.aggregate.potential_deltas`` over the shard
    axis: ``loads``/``speeds`` (S, K), ``mu``/``total_b`` (S,))."""
    s, _, k = aggregate.shape
    rows = aggregate.gather(1, loc_rows[:, :, None].expand(s, 1, k))
    source = torch.full((s, 1), machine, dtype=torch.int64,
                        device=aggregate.device)
    dest = cands.dest.long().clamp(max=k - 1)[:, None]
    return agg_mod.potential_deltas(rows, cands.weight[:, None], source,
                                    dest, loads, speeds, mu, total_b)


# ---------------------------------------------------------------------------
# Exchange + replicated apply (the O(K) part)
# ---------------------------------------------------------------------------

def _winner(cands: Candidate, eff: torch.Tensor, moved) -> Winner:
    """The winning shard along axis 0 (per column for a sweep): the
    highest ``eff``, exact ties to the lowest global node id."""
    best = torch.max(eff, dim=0, keepdim=True).values
    tie = eff == best
    shard = torch.argmin(torch.where(tie, cands.node, I32_MAX), dim=0,
                         keepdim=True)

    def at(x):
        return x.gather(0, shard)[0]
    return Winner(moved=moved(best[0]), node=at(cands.node),
                  dest=at(cands.dest), gain=best[0], weight=at(cands.weight),
                  shard=shard[0])


def elect(cands: Candidate, tol) -> Winner:
    """Pick the winning candidate from the gathered (S,) Candidate arrays
    ((S, K) for a sweep: one election per machine).

    Max gain wins; exact-gain ties break toward the lowest global node id —
    precisely the controller's first-maximum ``argmax`` over the full
    masked dissatisfaction vector.  A NaN gain wins the ``max`` and moves
    nothing (NaN > tol is false), as in ``jnp``.
    """
    return _winner(cands, cands.gain, lambda b: b > tol)


def elect_degraded(cands: Candidate, tol, lag: torch.Tensor,
                   stale_penalty) -> Winner:
    """Degraded-mode election under bounded staleness (DESIGN.md §15.2).

    A shard whose carried aggregate is ``lag`` winner broadcasts old only
    wins with gain above ``tol + lag * stale_penalty`` (arXiv:1109.6925's
    bounded-staleness threshold).  Callers mask unavailable shards (down /
    quarantined / undelivered) to ``-inf`` gain before electing.  ``lag``
    is (S,), broadcast over a sweep's machine axis.

    With ``lag == 0`` everywhere and no masks this is decision-equivalent
    to :func:`elect`: the winner, tie-break, and every ``moved``-gated
    field match bitwise.
    """
    thresh = tol + stale_penalty * lag.to(torch.float32)
    if cands.gain.ndim == 2:
        thresh = thresh[:, None]
    eff = torch.where(cands.gain > thresh, cands.gain, -float("inf"))
    return _winner(cands, eff, lambda b: b > -float("inf"))


def apply_move(assignment: torch.Tensor, loads: torch.Tensor,
               winner: Winner, col_delta: torch.Tensor,
               moved: torch.Tensor):
    """Apply the elected move to the replicated mirror + O(K) loads, with
    the controller's operations (``core.aggregate.apply_move``), so the
    replicated state stays bitwise the controller's.  ``col_delta`` is
    :func:`move_delta` of the (gated) move."""
    node = winner.node.long().reshape(1)
    new_loads = loads + winner.weight.reshape(1) * col_delta
    dest = winner.dest.to(assignment.dtype).reshape(1)
    moved_to = torch.where(moved.reshape(1),
                           dest.clamp(max=loads.shape[0] - 1),
                           assignment.index_select(0, node))
    return assignment.scatter(0, node, moved_to), new_loads


# ---------------------------------------------------------------------------
# Potential partials (pure reductions — O(1)/O(K) per shard)
# ---------------------------------------------------------------------------

def shard_load_partials(weights: torch.Tensor, valid: torch.Tensor,
                        r_local: torch.Tensor,
                        num_machines: int) -> torch.Tensor:
    """(S, K) fresh load partials: per shard, the sum of owned b over its
    nodes — ``machine_loads`` over each block, so one shard of the whole
    graph gives the controller's loads bitwise."""
    bv = torch.where(valid, weights, 0.0)
    return torch.stack([machine_loads(bv[s], r_local[s], num_machines)
                        for s in range(weights.shape[0])])


def shard_c0_partials(aggregate, weights, valid, r_local, fresh_loads,
                      speeds, mu, total_b) -> torch.Tensor:
    """(S,) shard contributions to C_0 = sum_i C_i (Thm. 3.1 potential):
    each shard's current node costs from its block aggregate, summed."""
    s, ns, k = aggregate.shape
    cost = shard_cost_from_aggregate(
        aggregate.reshape(s * ns, k), r_local.reshape(-1),
        weights.reshape(-1), fresh_loads, speeds, mu, total_b,
        costs.C_FRAMEWORK).reshape(s, ns, k)
    current = cost.gather(2, r_local.long()[..., None])[..., 0]
    current = torch.where(valid, current, 0.0)
    return torch.stack([torch.sum(current[i]) for i in range(s)])


def shard_cut_partials(row_block, valid, r_local,
                       assignment) -> torch.Tensor:
    """(S,) shards' (unhalved) cut contributions from their rows:
    sum_{i local} sum_j c_ij [r_i != r_j] — O(Ns*N) a shard."""
    out = []
    for s in range(row_block.shape[0]):
        diff = r_local[s][:, None] != assignment[None, :]
        rows = torch.where(valid[s][:, None], row_block[s], 0.0)
        out.append(torch.sum(rows * diff))
    return torch.stack(out)


def shard_cut_partials_from_aggregate(aggregate, valid,
                                      r_local) -> torch.Tensor:
    """(S,) shards' (unhalved) cut contributions from their carried block
    aggregates — O(Ns*K): sum_i degree_i - sum_i A[i, r_i] over the owned
    nodes (invariant I4 of DESIGN.md §10, in the controller's order,
    ``core.aggregate.cut_from_aggregate``)."""
    degree = torch.where(valid, costs.row_sum(aggregate)[..., 0], 0.0)
    internal = torch.where(
        valid, aggregate.gather(2, r_local.long()[..., None])[..., 0], 0.0)
    return torch.stack([torch.sum(degree[s]) - torch.sum(internal[s])
                        for s in range(aggregate.shape[0])])


def global_potentials(c0_partials, cut_partials, fresh_loads, speeds, mu,
                      total_b):
    """Reduce gathered partials to (C_0, Ct_0) — replicated compute, in the
    controller's order (``costs.global_cost_ct0``)."""
    c0 = torch.sum(c0_partials)
    cut = 0.5 * torch.sum(cut_partials)
    dev = fresh_loads / speeds - total_b
    ct0 = torch.sum(dev * dev) + 0.5 * mu * cut
    return c0, ct0
