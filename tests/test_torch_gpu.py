"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

These tests need an NVIDIA GPU and nvcc; they carry the ``gpu`` marker
and skip elsewhere.  They import neither JAX nor the reference package,
so they also run where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import dissatisfaction as D


def _arrays(n, k, seed):
    rng = np.random.default_rng(seed)
    adj = rng.uniform(0, 10, (n, n)) * (rng.random((n, n)) < 0.4)
    adj = np.triu(adj, 1)
    adj = (adj + adj.T).astype(np.float32)
    b = rng.uniform(0.1, 10, n).astype(np.float32)
    r = rng.integers(0, k, n).astype(np.int32)
    speeds = rng.uniform(0.2, 2.0, k).astype(np.float32)
    speeds /= speeds.sum()
    loads = np.zeros(k, np.float32)
    np.add.at(loads, r, b)
    theta = rng.uniform(0, 30, n).astype(np.float32)
    return adj, r, b, loads, speeds, theta


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(card, *arrays):
    return [torch.from_numpy(np.array(a)).to(card) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("n,k", [(1003, 16), (300, 128), (7, 2)])
def test_dissat_kernel_bitwise_twin(card, n, k, framework):
    """Kernel 1 == its twin bitwise on the card (best and dissat), with
    and without theta."""
    adj, r, b, loads, speeds, th = _arrays(n, k, seed=n + k)
    adj_t, r_t, b_t, loads_t, speeds_t, th_t = _on(card, adj, r, b, loads,
                                                   speeds, th)
    agg = adj_t @ (r_t.long()[:, None] == torch.arange(k, device=card)
                   ).float()
    mu = torch.tensor(8.0, device=card)
    for theta in (None, th_t):
        got = D.dissatisfaction_from_aggregate_cuda(
            agg, r_t, b_t, loads_t, speeds_t, mu, framework, theta=theta)
        want = D.dissatisfaction_from_aggregate_plain(
            agg, r_t, b_t, loads_t, speeds_t, mu, framework, theta=theta)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
def test_cost_matrix_kernel_matches_twin(card, framework):
    """Kernel 2 vs its twin on the card, square and a row block with the
    global B.  The kernel sums each aggregate entry in a fixed lane order,
    cuBLAS in its own, hence rtol 1e-5."""
    adj, r, b, loads, speeds, _ = _arrays(517, 16, seed=5)
    adj_t, r_t, b_t, loads_t, speeds_t = _on(card, adj, r, b, loads, speeds)
    mu = torch.tensor(8.0, device=card)
    got = D.cost_matrix_cuda(adj_t, r_t, b_t, loads_t, speeds_t, mu,
                             framework)
    want = D.cost_matrix_plain(adj_t, r_t, b_t, loads_t, speeds_t, mu,
                               framework)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    rows = slice(100, 333)
    total_b = torch.sum(b_t)
    got = D.cost_matrix_cuda(adj_t[rows].contiguous(), r_t,
                             b_t[rows].contiguous(), loads_t, speeds_t, mu,
                             framework, row_assignment=r_t[rows].contiguous(),
                             total_weight=total_b)
    want = D.cost_matrix_plain(adj_t[rows], r_t, b_t[rows], loads_t,
                               speeds_t, mu, framework,
                               row_assignment=r_t[rows], total_weight=total_b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(card):
    """K above the kernels' limit, a wrong dtype and a non-contiguous
    operand raise before any launch."""
    adj, r, b, loads, speeds, _ = _arrays(64, 4, seed=6)
    adj_t, r_t, b_t, loads_t, speeds_t = _on(card, adj, r, b, loads, speeds)
    agg = torch.zeros((64, D.MAX_K + 1), device=card)
    with pytest.raises(ValueError, match="K"):
        D.dissatisfaction_from_aggregate_cuda(
            agg, r_t, b_t, torch.ones(D.MAX_K + 1, device=card),
            torch.ones(D.MAX_K + 1, device=card), 8.0, "c")
    with pytest.raises(ValueError, match="int32"):
        D.cost_matrix_cuda(adj_t, r_t.long(), b_t, loads_t, speeds_t, 8.0,
                           "c")
    with pytest.raises(ValueError, match="contiguous"):
        D.cost_matrix_cuda(adj_t.T, r_t, b_t, loads_t, speeds_t, 8.0, "c")


def _sparse_on(card, n, k, seed):
    from repro_torch.core.sparse import make_sparse_problem
    from repro_torch.graphs.generators import (random_degree_graph_edges,
                                               random_weights_edges)
    s, r = random_degree_graph_edges(n, seed=seed)
    b, w = random_weights_edges(n, s, seed=seed + 1, mean=5.0)
    rng = np.random.default_rng(seed + 2)
    sp = make_sparse_problem(s, r, w, b, rng.uniform(0.5, 2.0, k), mu=8.0,
                             device=card)
    r0 = torch.as_tensor(rng.integers(0, k, n).astype(np.int32), device=card)
    return sp, r0


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("n,k", [(1003, 8), (300, 128), (5000, 3)])
def test_edge_kernels_bitwise_twins(card, n, k, framework):
    """Kernel 4 == its twin and == kernel 1 on the window-summed aggregate,
    bitwise; kernel 5 == its twin and == the first-maximum election from
    kernel 4's output, bitwise; with and without theta."""
    from repro_torch.core.costs import adjacency_aggregate_sparse
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    sp, r = _sparse_on(card, n, k, seed=n + k)
    b = sp.node_weights
    loads = machine_loads(b, r, k)
    agg = adjacency_aggregate_sparse(sp, r)
    for theta in (None, torch.full((n,), 0.5, device=card)):
        args = (sp, r, b, loads, sp.speeds, sp.mu, framework)
        got = E.dissatisfaction_from_edges_cuda(*args, theta=theta)
        twin = E.dissatisfaction_from_edges_plain(*args, theta=theta)
        one = D.dissatisfaction_from_aggregate_cuda(
            agg, r, b, loads, sp.speeds, sp.mu, framework, theta=theta)
        torch.cuda.synchronize()
        for want in (twin, one):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        sweep = E.sweep_candidates_from_edges_cuda(*args, theta=theta)
        twin5 = E.sweep_candidates_from_edges_plain(*args, theta=theta)
        elected = E.elect(got[0], got[1], r, k)
        torch.cuda.synchronize()
        for want in (twin5, elected):
            for a, c in zip(sweep, want):
                assert torch.equal(a, c)


@pytest.mark.gpu
def test_edge_kernels_refuse_what_they_do_not_take(card):
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    sp, r = _sparse_on(card, 200, 4, seed=3)
    loads = machine_loads(sp.node_weights, r, 4)
    with pytest.raises(ValueError, match="int32"):
        E.dissatisfaction_from_edges_cuda(sp, r.long(), sp.node_weights,
                                          loads, sp.speeds, sp.mu, "c")
    with pytest.raises(ValueError, match="K"):
        E.sweep_candidates_from_edges_cuda(
            sp, r, sp.node_weights, torch.ones(D.MAX_K + 1, device=card),
            torch.ones(D.MAX_K + 1, device=card), sp.mu, "c")


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("bsz,n,k", [(3, 1003, 8), (2, 300, 128),
                                     (4, 5000, 3)])
def test_batched_dissat_kernel_bitwise(card, bsz, n, k, framework):
    """Kernel 3 == its twin and == kernel 1 on each element, bitwise (best
    and dissat), with and without theta; each element has its own loads,
    speeds, mu and B."""
    rng = np.random.default_rng(bsz + n + k)
    agg = torch.as_tensor(rng.uniform(0, 50, (bsz, n, k)).astype(np.float32),
                          device=card)
    r = torch.as_tensor(rng.integers(0, k, (bsz, n)).astype(np.int32),
                        device=card)
    b = torch.as_tensor(rng.uniform(0.1, 10, (bsz, n)).astype(np.float32),
                        device=card)
    speeds = torch.as_tensor(rng.uniform(0.2, 2.0, (bsz, k))
                             .astype(np.float32), device=card)
    speeds = speeds / speeds.sum(dim=1, keepdim=True)
    from repro_torch.core.problem import machine_loads
    loads = torch.stack([machine_loads(b[e], r[e], k) for e in range(bsz)])
    mu = torch.as_tensor(rng.choice([4.0, 8.0, 16.0], bsz).astype(np.float32),
                         device=card)
    total = torch.stack([torch.sum(x) for x in b])
    for theta in (None, torch.full((bsz, n), 0.5, device=card)):
        got = D.dissatisfaction_from_aggregate_batched_cuda(
            agg, r, b, loads, speeds, mu, framework, theta=theta,
            total_weight=total)
        twin = D.dissatisfaction_from_aggregate_batched_plain(
            agg, r, b, loads, speeds, mu, framework, theta=theta,
            total_weight=total)
        torch.cuda.synchronize()
        assert torch.equal(got[1], twin[1])
        assert torch.equal(got[0], twin[0])
        for e in range(bsz):
            one = D.dissatisfaction_from_aggregate_cuda(
                agg[e], r[e], b[e], loads[e], speeds[e], mu[e], framework,
                theta=None if theta is None else theta[e],
                total_weight=total[e])
            torch.cuda.synchronize()
            assert torch.equal(got[1][e], one[1])
            assert torch.equal(got[0][e], one[0])


@pytest.mark.gpu
def test_batched_dissat_kernel_refuses_what_it_does_not_take(card):
    agg = torch.zeros((2, 10, 4), device=card)
    r = torch.zeros((2, 10), dtype=torch.int32, device=card)
    b = torch.ones((2, 10), device=card)
    w = torch.full((2, 4), 0.25, device=card)
    mu = torch.full((2,), 8.0, device=card)
    with pytest.raises(ValueError, match="mu"):
        D.dissatisfaction_from_aggregate_batched_cuda(
            agg, r, b, w, w, mu[:1], "c")
    with pytest.raises(ValueError, match="int32"):
        D.dissatisfaction_from_aggregate_batched_cuda(
            agg, r.long(), b, w, w, mu, "c")
    with pytest.raises(ValueError, match="B, rows, K"):
        D.dissatisfaction_from_aggregate_batched_cuda(
            agg[0], r[0], b[0], w[0], w[0], mu, "c")


def _rows_operands(card, bsz, n, k, seed, offset=0):
    """Kernel 3's operands, (B, n, K); the aggregate starts ``offset``
    floats into its buffer, so an offset that is not a multiple of 4
    leaves every slab off the 16-byte grid."""
    rng = np.random.default_rng(seed)
    flat = rng.uniform(0, 50, bsz * n * k + offset).astype(np.float32)
    agg = torch.as_tensor(flat, device=card)[offset:].view(bsz, n, k)
    if n > 2:   # a row of ties, and a machine id outside [0, K)
        agg[0, 1] = agg[0, 1, 0]
    r = torch.as_tensor(rng.integers(0, k, (bsz, n)).astype(np.int32),
                        device=card)
    if n > 3:
        r[0, 2] = k + 2
    b = torch.as_tensor(rng.uniform(0.1, 10, (bsz, n)).astype(np.float32),
                        device=card)
    sp = rng.uniform(0.2, 2.0, (bsz, k))
    speeds = torch.as_tensor((sp / sp.sum(axis=1, keepdims=True))
                             .astype(np.float32), device=card)
    loads = torch.as_tensor(rng.uniform(0, 5 * n / k, (bsz, k))
                            .astype(np.float32), device=card)
    mu = torch.as_tensor(rng.choice([4.0, 8.0, 16.0], bsz).astype(np.float32),
                         device=card)
    total = torch.stack([torch.sum(x) for x in b])
    return agg, r, b, loads, speeds, mu, total


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 127, 129, 1003])
@pytest.mark.parametrize("k", sorted(set(D.SPECIALISED_K) | {3, 17, 100,
                                                             128}))
def test_dissat_kernels_every_instance_bitwise(card, k, rows):
    """Kernels 1 and 3 == their twins bitwise at every specialised K and
    on the runtime-K instance, at row counts around a block's, with slabs
    on and off the 16-byte grid; kernel 3 at B = 1 == kernel 1; c and ct,
    theta absent and 0.5."""
    for offset in (0, 1):
        agg, r, b, loads, speeds, mu, total = _rows_operands(
            card, 3, rows, k, seed=k * 10_000 + rows, offset=offset)
        for framework in ("c", "ct"):
            for theta in (None, torch.full((3, rows), 0.5, device=card)):
                got3 = D.dissatisfaction_from_aggregate_batched_cuda(
                    agg, r, b, loads, speeds, mu, framework, theta=theta,
                    total_weight=total)
                twin3 = D.dissatisfaction_from_aggregate_batched_plain(
                    agg, r, b, loads, speeds, mu, framework, theta=theta,
                    total_weight=total)
                th0 = None if theta is None else theta[0]
                one = D.dissatisfaction_from_aggregate_cuda(
                    agg[0], r[0], b[0], loads[0], speeds[0], mu[0],
                    framework, theta=th0, total_weight=total[0])
                twin1 = D.dissatisfaction_from_aggregate_plain(
                    agg[0], r[0], b[0], loads[0], speeds[0], mu[0],
                    framework, theta=th0, total_weight=total[0])
                at_b1 = D.dissatisfaction_from_aggregate_batched_cuda(
                    agg[:1], r[:1], b[:1], loads[:1], speeds[:1], mu[:1],
                    framework, theta=None if theta is None else theta[:1],
                    total_weight=total[:1])
                torch.cuda.synchronize()
                for got, want in ((got3, twin3), (one, twin1),
                                  ((at_b1[0][0], at_b1[1][0]), one)):
                    assert torch.equal(got[1], want[1])
                    assert torch.equal(got[0], want[0])


@pytest.mark.gpu
def test_dissat_kernels_launch_on_the_current_stream(card):
    """Under ``torch.cuda.stream(s)`` kernels 1 and 3 run on ``s``: their
    input is written on ``s`` behind a long sleep, so a launch on any other
    stream would read the NaNs the buffer held before."""
    agg, r, b, loads, speeds, mu, total = _rows_operands(card, 2, 5000, 16,
                                                         seed=7)
    late = torch.full_like(agg, float("nan"))
    want3 = D.dissatisfaction_from_aggregate_batched_plain(
        agg, r, b, loads, speeds, mu, "c", total_weight=total)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(200_000_000)
        late.copy_(agg)
        got3 = D.dissatisfaction_from_aggregate_batched_cuda(
            late, r, b, loads, speeds, mu, "c", total_weight=total)
        got1 = D.dissatisfaction_from_aggregate_cuda(
            late[1], r[1], b[1], loads[1], speeds[1], mu[1], "c",
            total_weight=total[1])
    s.synchronize()
    assert torch.equal(got3[0], want3[0]) and torch.equal(got3[1], want3[1])
    assert torch.equal(got1[0], want3[0][1])
    assert torch.equal(got1[1], want3[1][1])


@pytest.mark.gpu
def test_dissat_stream_read_is_the_current_stream(card):
    """The wrappers read the stream through a private PyTorch call; it
    must exist and give what the public one gives, on the default stream
    and under ``torch.cuda.stream(s)``."""
    assert hasattr(torch._C, "_cuda_getCurrentRawStream"), (
        "this PyTorch has no torch._C._cuda_getCurrentRawStream: "
        "repro_torch.kernels.dissatisfaction._stream needs another read")
    dev = torch.device(card.type, torch.cuda.current_device())
    assert D._stream(dev) == torch.cuda.current_stream(dev).cuda_stream
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert D._stream(dev) == s.cuda_stream


@pytest.mark.gpu
def test_dissat_kernels_raise_on_a_refused_launch(card, monkeypatch):
    """The C entry points refuse K outside [1, 128] and B outside [1,
    65535] with a status, and a wrapper raises RuntimeError on any status
    but 0; the next launch is clean."""
    from repro_torch.kernels import _build
    lib = _build.library()
    agg, r, b, loads, speeds, mu, total = _rows_operands(card, 1, 64, 4,
                                                         seed=8)
    dissat, best = torch.empty_like(b), torch.empty_like(r)
    ptrs = [t.data_ptr() for t in (agg, r, b)] + [None] + [
        t.data_ptr() for t in (loads, speeds, mu, total, dissat, best)]
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.dissat_from_aggregate(*ptrs, 64, 0, 0, stream) != 0
    assert lib.dissat_from_aggregate(*ptrs, 64, 129, 0, stream) != 0
    assert lib.dissat_from_aggregate_batched(*ptrs, 0, 64, 4, 0, stream) != 0
    assert lib.dissat_from_aggregate_batched(*ptrs, 65536, 64, 4, 0,
                                             stream) != 0
    args = (agg[0], r[0], b[0], loads[0], speeds[0], mu[0], "c")
    for name in ("dissat_from_aggregate", "dissat_from_aggregate_batched"):
        D._entry_point(name)
        monkeypatch.setitem(D._entry_points, name, lambda *a: 1)
    with pytest.raises(RuntimeError, match="failed to launch"):
        D.dissatisfaction_from_aggregate_cuda(*args)
    with pytest.raises(RuntimeError, match="failed to launch"):
        D.dissatisfaction_from_aggregate_batched_cuda(
            agg, r, b, loads, speeds, mu, "c")
    monkeypatch.undo()
    got = D.dissatisfaction_from_aggregate_cuda(*args)
    want = D.dissatisfaction_from_aggregate_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# kernels 6-7: attention.  Tolerances: f32 atol = rtol = 2e-5 (the kernel
# and its twin sum the same f32 products in different orders); bf16 rtol
# 1e-2, atol 1e-3 (one rounding of the output to bf16, 2^-7 relative at
# most, on either side of a tie).
# ---------------------------------------------------------------------------

_ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}


def _normal(card, shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(card, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,d,s", [(4, 32, 8, 128, 1000),
                                         (3, 8, 1, 64, 777),
                                         (2, 4, 4, 16, 130),
                                         (2, 8, 2, 8, 65),
                                         (2, 8, 2, 112, 300),
                                         (2, 8, 4, 32, 200),
                                         (16, 20, 20, 128, 4096),
                                         (2, 8, 2, 100, 300),
                                         (3, 6, 2, 37, 500),
                                         (2, 48, 1, 128, 300)])
def test_decode_attention_kernel_matches_twin(card, b, h, hkv, d, s, dtype):
    """Kernel 6 vs its twin and the ``-inf``-masked oracle, ragged lengths
    1..S and one above S (clamped); values past a row's length change
    nothing.  (16, 20, 20, 128, 4096) is the serving shape; D = 100 and 37
    take the instance that stages without TMA; G = 48 (granite-34b's
    heads) keeps its (row, part) states in shared memory."""
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import ref as R
    q = _normal(card, (b, h, d), s + 1, dtype)
    k = _normal(card, (b, s, hkv, d), s + 2, dtype)
    v = _normal(card, (b, s, hkv, d), s + 3, dtype)
    rng = np.random.default_rng(s)
    lens = rng.integers(1, s + 1, b)
    lens[0] = s + 17
    length = torch.as_tensor(lens.astype(np.int32), device=card)
    got = A.decode_attention_cuda(q, k, v, length)
    want = A.decode_attention_twin(q, k, v, length)
    oracle = R.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, d)
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])
    torch.testing.assert_close(got.float(), oracle.float(),
                               **_ATTN_TOL[dtype])
    short = torch.as_tensor(np.minimum(lens, s // 2).astype(np.int32),
                            device=card)
    poisoned_k, poisoned_v = k.clone(), v.clone()
    poisoned_k[:, s // 2:] = 1e4
    poisoned_v[:, s // 2:] = -1e4
    a = A.decode_attention_cuda(q, k, v, short)
    c = A.decode_attention_cuda(q, poisoned_k, poisoned_v, short)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_on_split_borders(card, dtype):
    """Kernel 6 with lengths on the wrapper's split borders (one split,
    two, one past each, one short of three), G = 7 and G = 1."""
    from repro_torch.kernels import decode_attention as A
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, h, hkv, d, s in ((7, 56, 8, 128, 2000), (7, 4, 4, 64, 1000)):
        split = A.split_size(s, b * hkv, sms)
        assert -(-s // split) > 2
        lens = np.asarray([split, split + 1, 2 * split, 2 * split + 1,
                           3 * split - 1, split - 1, 1], np.int32)
        q = _normal(card, (b, h, d), s + 7, dtype)
        k = _normal(card, (b, s, hkv, d), s + 8, dtype)
        v = _normal(card, (b, s, hkv, d), s + 9, dtype)
        length = torch.as_tensor(lens, device=card)
        got = A.decode_attention_cuda(q, k, v, length)
        want = A.decode_attention_twin(q, k, v, length)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **_ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_is_deterministic(card, dtype):
    """Two calls on the same inputs give the same bits (the splits are
    combined in split order, no float atomics), also when other calls of
    another shape run in between."""
    from repro_torch.kernels import decode_attention as A
    b, h, hkv, d, s = 16, 20, 20, 128, 4096
    q = _normal(card, (b, h, d), 1, dtype)
    k = _normal(card, (b, s, hkv, d), 2, dtype)
    v = _normal(card, (b, s, hkv, d), 3, dtype)
    lens = np.random.default_rng(4).integers(1, s + 1, b).astype(np.int32)
    length = torch.as_tensor(lens, device=card)
    first = A.decode_attention_cuda(q, k, v, length)
    A.decode_attention_cuda(q[:2, :8].contiguous(), k[:2, :, :8].contiguous(),
                            v[:2, :, :8].contiguous(), length[:2])
    for _ in range(3):
        assert torch.equal(A.decode_attention_cuda(q, k, v, length), first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 1000, 32, 8, 128),
                                         (1, 333, 8, 1, 64),
                                         (2, 70, 4, 4, 16),
                                         (1, 129, 14, 2, 8),
                                         (1, 3072, 4, 4, 112),
                                         (2, 63, 8, 2, 96),
                                         (1, 1, 4, 1, 112),
                                         (1, 130, 14, 2, 100)])
def test_flash_attention_kernel_matches_twin(card, b, s, h, hkv, d, dtype):
    """Kernel 7 vs its twin and the ``-inf``-masked oracle at unpadded S
    (1 to 3072), G in {1, 4, 7, 8}, head_dim 8 to 128 (112, 96 and 100 not
    powers of two, 100 not a multiple of 8)."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ref as R
    q = _normal(card, (b, s, h, d), s + 4, dtype)
    k = _normal(card, (b, s, hkv, d), s + 5, dtype)
    v = _normal(card, (b, s, hkv, d), s + 6, dtype)
    got = F.flash_attention_cuda(q, k, v)
    want = F.flash_attention_twin(q, k, v)
    oracle = R.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])
    torch.testing.assert_close(got.float(), oracle.float(),
                               **_ATTN_TOL[dtype])


@pytest.mark.gpu
def test_attention_kernels_refuse_what_they_do_not_take(card):
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import flash_attention as F
    q = torch.zeros((2, 4, 64), device=card)
    k = torch.zeros((2, 10, 2, 64), device=card)
    length = torch.full((2,), 5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.decode_attention_cuda(q.half(), k.half(), k.half(), length)
    with pytest.raises(ValueError, match="contiguous"):
        A.decode_attention_cuda(q, k.transpose(0, 1).contiguous()
                                .transpose(0, 1), k, length)
    wide_q = torch.zeros((2, 4, 264), device=card)
    wide_k = torch.zeros((2, 10, 2, 264), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        A.decode_attention_cuda(wide_q, wide_k, wide_k, length)
    with pytest.raises(ValueError, match="int32"):
        A.decode_attention_cuda(q, k, k, length.long())
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_cuda(q.cpu(), k.cpu(), k.cpu(), length.cpu())
    qf = torch.zeros((1, 10, 4, 264), device=card)
    kf = torch.zeros((1, 10, 2, 264), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        F.flash_attention_cuda(qf, kf, kf)
    with pytest.raises(ValueError, match="bfloat16"):
        F.flash_attention_cuda(qf[..., :64].contiguous().bfloat16(),
                               kf[..., :64].contiguous(),
                               kf[..., :64].contiguous())
    # groups too large for one block: the launchers refuse them, the
    # wrappers raise, and the next launch is unaffected
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(RuntimeError, match="failed to launch"):
            F.flash_attention_cuda(
                torch.zeros((1, 4, 65, 8), device=card, dtype=dtype),
                torch.zeros((1, 4, 1, 8), device=card, dtype=dtype),
                torch.zeros((1, 4, 1, 8), device=card, dtype=dtype))
    with pytest.raises(RuntimeError, match="failed to launch"):
        A.decode_attention_cuda(torch.zeros((1, 130, 128), device=card),
                                torch.zeros((1, 8, 1, 128), device=card),
                                torch.zeros((1, 8, 1, 128), device=card),
                                length[:1])
    out = A.decode_attention_cuda(q, k, k, length)
    torch.testing.assert_close(out, A.decode_attention_twin(q, k, k, length))


# ---------------------------------------------------------------------------
# kernel 8: the SSD scan.  Tolerance: max |got - want| <= 3e-4 * max(1,
# max |want|), for y and the final state each — the reference's own
# tolerance between two chunkings of the scan (``test_ssd_scan_kernel_
# matches_model_path``), taken against the largest value.  The kernel and
# its twin read the same inputs in f32 (bf16 inputs are widened exactly),
# so bf16 needs no more.
# ---------------------------------------------------------------------------

_SSD_TOL = 3e-4


def _ssd_inputs(card, b, seq, h, p, n, dtype, seed, mamba=False):
    """Inputs of the reference's kernel tests, or (``mamba``) decays of
    the Mamba2 initialisation: a in [-16, -1], dt in [1e-3, 0.1]."""
    rng = np.random.default_rng(seed)
    if mamba:
        dt = rng.uniform(1e-3, 0.1, (b, seq, h))
        a = -rng.uniform(1.0, 16.0, h)
    else:
        dt = rng.uniform(0.01, 0.5, (b, seq, h))
        a = -rng.uniform(0.1, 2.0, h)
    x, bm, cm = (rng.standard_normal(s) for s in
                 ((b, seq, h, p), (b, seq, n), (b, seq, n)))
    on = [torch.from_numpy(v.astype(np.float32)).to(card)
          for v in (x, dt, a, bm, cm)]
    on[0], on[3], on[4] = (t.to(dtype) for t in (on[0], on[3], on[4]))
    return on


def _ssd_close(got, want):
    bound = _SSD_TOL * max(1.0, float(want.abs().max()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("b,seq,h,p,n,chunk,dtype,mamba", [
    (1, 3072, 64, 64, 128, 256, torch.bfloat16, True),   # the serving shape
    (2, 1001, 8, 64, 128, 256, torch.float32, True),
    (2, 100, 3, 8, 5, 16, torch.float32, False),
    (1, 37, 2, 33, 16, 16, torch.float32, False),         # L < the sub-chunk
    (3, 130, 4, 32, 16, 16, torch.bfloat16, False),
    # the bf16 kernel: widths the wrapper pads to multiples of 8, and L
    # around its 256-step chunk
    (2, 500, 8, 33, 24, 256, torch.bfloat16, True),
    (1, 300, 4, 64, 5, 256, torch.bfloat16, False),
    (1, 1, 4, 64, 128, 256, torch.bfloat16, True),
    (1, 255, 4, 64, 128, 256, torch.bfloat16, True),
    (1, 256, 4, 64, 128, 256, torch.bfloat16, True),
    (1, 257, 4, 64, 128, 256, torch.bfloat16, True),
    (1, 300, 2, 64, 256, 256, torch.bfloat16, True),
])
def test_ssd_scan_kernel_matches_twin(card, b, seq, h, p, n, chunk, dtype,
                                      mamba):
    """Kernel 8 vs its twin (at the model's chunk) from zeros and from an
    initial state, at L not a multiple of the kernel's sub-chunk, P not a
    multiple of its row tile, and underflowing decays."""
    from repro_torch.kernels import ssd_scan as S
    x, dt, a, bm, cm = _ssd_inputs(card, b, seq, h, p, n, dtype, seq + n,
                                   mamba)
    init = torch.from_numpy(np.random.default_rng(seq).standard_normal(
        (b, h, p, n)).astype(np.float32)).to(card)
    for start in (None, init):
        got = S.ssd_scan_cuda(x, dt, a, bm, cm, start)
        want = S.ssd_scan_twin(x, dt, a, bm, cm, chunk, start)
        torch.cuda.synchronize()
        _ssd_close(got[0], want[0])
        _ssd_close(got[1], want[1])


@pytest.mark.gpu
def test_ssd_scan_kernel_matches_recurrence(card):
    """Kernel 8 vs the per-token recurrence of ``kernels/ref.py``."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssd_scan as S
    x, dt, a, bm, cm = _ssd_inputs(card, 2, 200, 3, 40, 24, torch.float32, 9)
    got = S.ssd_scan_cuda(x, dt, a, bm, cm)
    want = R.ssd_scan_ref(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    _ssd_close(got[0], want[0])
    _ssd_close(got[1], want[1])


@pytest.mark.gpu
def test_ssd_scan_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels import ssd_scan as S
    x, dt, a, bm, cm = _ssd_inputs(card, 1, 70, 2, 16, 8, torch.float32, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        S.ssd_scan_cuda(x.half(), dt, a, bm.half(), cm.half())
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        S.ssd_scan_cuda(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(ValueError, match="bm must be torch.bfloat16"):
        S.ssd_scan_cuda(x.bfloat16(), dt, a, bm, cm.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        S.ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                        a, bm, cm)
    with pytest.raises(ValueError, match="init_state"):
        S.ssd_scan_cuda(x, dt, a, bm, cm, torch.zeros((1, 2, 16, 9),
                                                      device=card))
    with pytest.raises(ValueError, match="CUDA"):
        S.ssd_scan_cuda(x.cpu(), dt.cpu(), a.cpu(), bm.cpu(), cm.cpu())
    # N = 512 needs more shared memory than a block has: the launcher
    # refuses it, the wrapper raises, and the next launch is unaffected
    big = torch.zeros((1, 70, 512), device=card)
    with pytest.raises(RuntimeError, match="failed to launch"):
        S.ssd_scan_cuda(x, dt, a, big, big)
    got = S.ssd_scan_cuda(x, dt, a, bm, cm)
    want = S.ssd_scan_twin(x, dt, a, bm, cm, 32)
    _ssd_close(got[0], want[0])


@pytest.mark.gpu
def test_ssd_scan_bf16_refuses_past_its_widths(card):
    """The bf16 kernel takes P <= 64 and N <= 256 (the f32 one takes
    more): the wrapper refuses wider bf16 inputs, and the next launch is
    unaffected."""
    from repro_torch.kernels import ssd_scan as S
    for p, n in ((72, 16), (16, 264)):
        x, dt, a, bm, cm = _ssd_inputs(card, 1, 70, 2, p, n, torch.bfloat16,
                                       p + n)
        with pytest.raises(ValueError, match="the bf16 kernel takes P"):
            S.ssd_scan_cuda(x, dt, a, bm, cm)
    x, dt, a, bm, cm = _ssd_inputs(card, 1, 70, 2, 16, 8, torch.bfloat16, 2)
    got = S.ssd_scan_cuda(x, dt, a, bm, cm)
    want = S.ssd_scan_twin(x, dt, a, bm, cm, 32)
    torch.cuda.synchronize()
    _ssd_close(got[0], want[0])
    _ssd_close(got[1], want[1])
