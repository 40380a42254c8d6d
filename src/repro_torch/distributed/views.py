"""Per-machine local views of the partition game (DESIGN.md §9.1), PyTorch
port of ``repro.distributed.views``.

The distributed runtime statically shards the *node arrays* into S
contiguous blocks: shard s owns rows ``[s*Ns, (s+1)*Ns)`` of the adjacency
matrix, the matching slice of node weights, and nothing else.  Everything a
shard needs beyond its block is either

  * replicated O(K) state (the machine-load vector, machine speeds, mu,
    the global weight total B) kept fresh by the O(K) per-turn deltas of
    :mod:`~repro_torch.distributed.protocol`, or
  * the assignment mirror, initialized once (O(boundary) ghost sync — a
    shard only ever *reads* the assignment of nodes adjacent to its own,
    see :func:`boundary_stats`) and thereafter maintained by the O(1)
    per-turn move broadcasts.

The game-owner of a node is a *value* (the assignment vector), not a
storage location, so every shape stays fixed for the whole run.

Padding: only the row dimension is padded (to ``ceil(N/S)`` rows per
shard).  The (S, Ns, N) row blocks are one contiguous tensor, so the
(S*Ns, N) view a kernel takes is free; when S divides N they are a view
of the adjacency itself, with no copy.  Padded rows carry zero adjacency
and zero weight, and are masked out of candidate selection via ``valid``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.problem import PartitionProblem


class ShardViews(NamedTuple):
    """Stacked per-shard local state; leading axis = shard index.

    The emulated drivers keep the whole stack on one device; the collective
    driver gives each rank a stack of one, its own block.
    """
    row_block: torch.Tensor   # (S, Ns, N) float — adjacency rows owned
    weights: torch.Tensor     # (S, Ns) float — b_i of owned rows (0 pad)
    ids: torch.Tensor         # (S, Ns) int32 — global node ids (clamped to
                              #                N-1 for padding; see valid)
    valid: torch.Tensor       # (S, Ns) bool — False for padded rows

    @property
    def num_shards(self) -> int:
        return self.row_block.shape[0]

    @property
    def shard_size(self) -> int:
        return self.row_block.shape[1]

    @property
    def num_nodes(self) -> int:
        return self.row_block.shape[2]

    def flat_rows(self) -> torch.Tensor:
        """The (S*Ns, N) row blocks as one matrix (a view)."""
        return self.row_block.reshape(-1, self.num_nodes)


def _shard_size(n: int, num_shards: int) -> int:
    if not 1 <= num_shards <= n:
        raise ValueError(f"num_shards={num_shards} must be in [1, {n}]")
    return -(-n // num_shards)                  # rows per shard (ceil)


def pad_rows(x: torch.Tensor, num_shards: int, fill=0) -> torch.Tensor:
    """``x`` (N, ...) padded along its first axis to S*ceil(N/S) rows with
    ``fill`` and shaped (S, Ns, ...); a view of ``x`` when S divides N."""
    n = x.shape[0]
    ns = _shard_size(n, num_shards)
    npad = ns * num_shards
    if npad != n:
        tail = x.new_full((npad - n,) + tuple(x.shape[1:]), fill)
        x = torch.cat([x, tail])
    return x.reshape((num_shards, ns) + tuple(x.shape[1:]))


def build_views(problem: PartitionProblem, num_shards: int) -> ShardViews:
    """Slice ``problem`` into S contiguous row-block shards (row-padded)."""
    n = problem.num_nodes
    ns = _shard_size(n, num_shards)
    npad = ns * num_shards
    dev = problem.device
    ids = torch.clamp(torch.arange(npad, dtype=torch.int32, device=dev),
                      max=n - 1)
    valid = torch.arange(npad, device=dev) < n
    return ShardViews(
        row_block=pad_rows(problem.adjacency, num_shards),
        weights=pad_rows(problem.node_weights, num_shards),
        ids=ids.reshape(num_shards, ns),
        valid=valid.reshape(num_shards, ns),
    )


def shard_node_values(values, num_shards: int, fill=0.0) -> torch.Tensor:
    """Pad + reshape an (N,) per-node array into (S, Ns) shard blocks with
    the same row layout as :func:`build_views` (padding rows get ``fill``).

    Used for per-node side inputs that must be read shard-locally — e.g.
    the hysteresis threshold ``theta`` (DESIGN.md §11), which never
    crosses the wire: each shard only ever evaluates its own block.
    """
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values))
    return pad_rows(values, num_shards, fill).contiguous()


@dataclasses.dataclass(frozen=True)
class BoundaryStats:
    """Host-side ghost/boundary summary per shard (powers accounting).

    ``boundary_nodes[s]`` — owned nodes with at least one edge leaving the
    shard; ``ghost_nodes[s]`` — off-shard nodes adjacent to the shard (the
    assignment entries shard s actually has to mirror); ``cross_edges[s]``
    — edges from shard s to any other shard.
    """
    num_shards: int
    num_nodes: int
    boundary_nodes: np.ndarray   # (S,) int64
    ghost_nodes: np.ndarray      # (S,) int64
    cross_edges: np.ndarray      # (S,) int64

    @property
    def total_ghosts(self) -> int:
        return int(self.ghost_nodes.sum())

    @property
    def total_boundary(self) -> int:
        return int(self.boundary_nodes.sum())


def boundary_stats(problem: PartitionProblem, num_shards: int) -> BoundaryStats:
    """Compute the ghost/boundary structure of a static contiguous sharding.

    Counted on the adjacency's device, one (Ns, N) row block at a time,
    and read back in one (S, 3) transfer."""
    adj = problem.adjacency.detach()
    n = adj.shape[0]
    ns = -(-n // num_shards)
    cols = torch.arange(n, device=adj.device)
    counts = []
    for s in range(num_shards):
        block = adj[s * ns:(s + 1) * ns] > 0
        off = (cols < s * ns) | (cols >= (s + 1) * ns)
        out_edges = block & off
        counts.append(torch.stack([torch.sum(out_edges.any(dim=1)),
                                   torch.sum(block.any(dim=0) & off),
                                   torch.sum(out_edges)]))
    boundary, ghosts, cross = torch.stack(counts).cpu().numpy() \
        .astype(np.int64).T
    return BoundaryStats(num_shards=num_shards, num_nodes=n,
                         boundary_nodes=np.ascontiguousarray(boundary),
                         ghost_nodes=np.ascontiguousarray(ghosts),
                         cross_edges=np.ascontiguousarray(cross))
