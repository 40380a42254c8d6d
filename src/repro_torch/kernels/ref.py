"""Plain PyTorch oracles (port of ``repro.kernels.ref``): the ground truth
the kernels and their twins are held against, in the reference oracles'
own op order — the cost matrix, the two attention functions with an
f32 softmax over the fully built logits and ``-inf`` masks, and the SSD
scan as a per-token recurrence."""
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


def decode_attention_ref(q, k, v, length) -> torch.Tensor:
    """Single-token decode attention — oracle for kernel 6.

    q: (B, H, D); k/v: (B, S, Hkv, D) with Hkv | H (GQA); ``length`` (B,)
    gives the valid prefix of the cache.  Returns (B, H, D) in q's dtype.
    """
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.to(torch.float32),
                          k.to(torch.float32)) \
        / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    length = torch.as_tensor(length, device=q.device)
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        < length[:, None, None, None]
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def flash_attention_ref(q, k, v) -> torch.Tensor:
    """Causal GQA attention — oracle for kernel 7.

    q: (B, S, H, D); k/v: (B, S, Hkv, D) with Hkv | H.  Builds the S x S
    logits (the thing the kernel never builds).
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) \
        / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logits = torch.where(mask[None, None, None], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def ssd_scan_ref(x, dt, a, bm, cm):
    """Naive per-token SSD recurrence, independent of any chunking:
    s_t = exp(dt_t a) s_{t-1} + dt_t B_t ⊗ x_t;  y_t = C_t · s_t.
    Returns (y (B, L, H, P) f32, final state (B, H, P, N) f32)."""
    b, seq, h, p = x.shape
    f32 = torch.float32
    x, dt, bm, cm, a = (t.to(f32) for t in (x, dt, bm, cm, a))
    s = torch.zeros((b, h, p, bm.shape[-1]), dtype=f32, device=x.device)
    ys = []
    for t in range(seq):
        decay = torch.exp(dt[:, t] * a[None, :])                 # (B, H)
        s = s * decay[:, :, None, None] \
            + torch.einsum("bh,bn,bhp->bhpn", dt[:, t], bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cm[:, t], s))
    return torch.stack(ys, dim=1), s
