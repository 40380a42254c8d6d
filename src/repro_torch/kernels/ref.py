"""Plain PyTorch oracle for the cost-matrix kernel (port of
``repro.kernels.ref.cost_matrix_ref``): the ground truth the kernels and
their twins are held against, in the reference oracle's own op order."""
from __future__ import annotations

import torch


def cost_matrix_ref(adjacency, assignment, node_weights, loads, speeds, mu,
                    framework: str) -> torch.Tensor:
    """(N, K) node-cost matrix from raw tensors (independent of the problem
    containers)."""
    k = speeds.shape[0]
    f32 = torch.float32
    adjacency = adjacency.to(f32)
    b = node_weights.to(f32)
    kidx = torch.arange(k, device=adjacency.device)
    onehot = (assignment.long()[:, None] == kidx).to(f32)
    aggregate = adjacency @ onehot                               # (N, K)
    degree = torch.sum(aggregate, dim=-1, keepdim=True)
    own = onehot
    others = loads.to(f32)[None, :] - b[:, None] * own
    cut_term = 0.5 * torch.as_tensor(mu, dtype=f32,
                                     device=adjacency.device) \
        * (degree - aggregate)
    inv_w = 1.0 / speeds.to(f32)[None, :]
    if framework == "c":
        return (b[:, None] * inv_w) * others + cut_term
    if framework == "ct":
        total = torch.sum(b)
        bcol = b[:, None]
        inv_w2 = inv_w * inv_w
        return ((bcol * bcol) * inv_w2
                + 2.0 * bcol * inv_w2 * others
                - 2.0 * bcol * inv_w * total) + cut_term
    raise ValueError(framework)
