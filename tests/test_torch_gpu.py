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


def _sparse_on(card, n, k, seed, graph="random_degree"):
    """A sparse problem and a random assignment on the card; ``graph``
    "barabasi" is ``preferential_attachment_edges(n, m=2)`` (its first
    nodes are hubs), "star" adds edges from node 0 to nodes 1..5000 (a row
    spanning five of kernels 4-5's chunks)."""
    from repro_torch.core.sparse import make_sparse_problem
    from repro_torch.graphs.generators import (preferential_attachment_edges,
                                               random_degree_graph_edges,
                                               random_weights_edges)
    if graph == "barabasi":
        s, r = preferential_attachment_edges(n, seed=seed, m=2)
    else:
        s, r = random_degree_graph_edges(n, seed=seed)
    if graph == "star":
        s = np.concatenate([s, np.zeros(5000, s.dtype)])
        r = np.concatenate([r, np.arange(1, 5001, dtype=r.dtype)])
    b, w = random_weights_edges(n, s, seed=seed + 1, mean=5.0)
    rng = np.random.default_rng(seed + 2)
    sp = make_sparse_problem(s, r, w, b, rng.uniform(0.5, 2.0, k), mu=8.0,
                             device=card)
    r0 = torch.as_tensor(rng.integers(0, k, n).astype(np.int32), device=card)
    return sp, r0


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("n,k,graph", [
    (1003, 8, "random_degree"), (300, 128, "random_degree"),
    (5000, 3, "random_degree"), (20000, 8, "barabasi"),
    (20000, 16, "barabasi"), (20000, 8, "star")])
def test_edge_kernels_bitwise_twins(card, n, k, graph, framework):
    """Kernel 4 == its twin and == kernel 1 on the window-summed aggregate,
    bitwise; kernel 5 == its twin and == the first-maximum election from
    kernel 4's output, bitwise; with and without theta; on hub graphs
    whose rows span several chunks too."""
    from repro_torch.core.costs import adjacency_aggregate_sparse
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    sp, r = _sparse_on(card, n, k, seed=n + k, graph=graph)
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
def test_edge_kernels_take_unaligned_edge_arrays(card):
    """Edge arrays that do not start on 16 bytes (views one element into
    their buffers) give the same bits as aligned ones."""
    import dataclasses
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    sp, r = _sparse_on(card, 20000, 8, seed=4, graph="star")
    shifted = dataclasses.replace(
        sp, receivers=torch.cat([sp.receivers[:1], sp.receivers])[1:],
        edge_weights=torch.cat([sp.edge_weights[:1], sp.edge_weights])[1:])
    assert shifted.receivers.data_ptr() % 16 != 0
    loads = machine_loads(sp.node_weights, r, 8)
    args = (r, sp.node_weights, loads, sp.speeds, sp.mu, "ct")
    for fn in (E.dissatisfaction_from_edges_cuda,
               E.sweep_candidates_from_edges_cuda):
        got, want = fn(shifted, *args), fn(sp, *args)
        torch.cuda.synchronize()
        for a, c in zip(got, want):
            assert torch.equal(a, c)


@pytest.mark.gpu
def test_sweep_kernel_is_deterministic_and_resets_its_ticket(card):
    """Kernel 5 twice on the same inputs gives the same bits, also with a
    call of another shape between, and every launch leaves the ticket at
    zero."""
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    sp, r = _sparse_on(card, 20000, 8, seed=5, graph="barabasi")
    small, r_small = _sparse_on(card, 1003, 8, seed=6)
    args = (sp, r, sp.node_weights, machine_loads(sp.node_weights, r, 8),
            sp.speeds, sp.mu, "c")
    first = E.sweep_candidates_from_edges_cuda(*args)
    E.sweep_candidates_from_edges_cuda(
        small, r_small, small.node_weights,
        machine_loads(small.node_weights, r_small, 8), small.speeds,
        small.mu, "c")
    for _ in range(3):
        again = E.sweep_candidates_from_edges_cuda(*args)
        torch.cuda.synchronize()
        for a, c in zip(again, first):
            assert torch.equal(a, c)
        assert int(E._ticket(r.device)[0]) == 0


def _smoke():
    """``chip_smoke.py`` as a module, for its helpers."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.gpu
def test_sweep_kernel_is_one_launch(card):
    """Each kernel 5 call adds one to its launch count and makes exactly
    one device launch, counted by ``chip_smoke.device_launches`` as the
    kernel nodes of a CUDA graph that captures the calls (the combine is
    inside the kernel); the profiler names no other kernel."""
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    smoke = _smoke()
    sp, r = _sparse_on(card, 20000, 8, seed=8)
    b = sp.node_weights
    args = (sp, r, b, machine_loads(b, r, 8), sp.speeds,
            D._scalar(sp.mu, r.device), "c")
    total = torch.sum(b)
    before = E.launches["sweep_candidates_from_edges"]
    kernels, others, names = smoke.device_launches(
        lambda: E.sweep_candidates_from_edges_cuda(*args, total_weight=total),
        calls=5, reps=20)
    # a warm-up call, five captured, twenty profiled
    assert E.launches["sweep_candidates_from_edges"] == before + 26
    assert (kernels, others) == (1.0, 0.0)
    assert len(names) == 1, names
    assert "sweep_candidates_from_edges_kernel" in names[0]
    assert not E._ticket(r.device).any()


@pytest.mark.gpu
def test_edge_kernels_launch_on_the_current_stream(card):
    """Under ``torch.cuda.stream(s)`` kernels 4 and 5 run on ``s``: their
    assignment is written on ``s`` behind a long sleep, so a launch on any
    other stream would read the machines the buffer held before."""
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    sp, r = _sparse_on(card, 5000, 8, seed=9)
    b = sp.node_weights
    loads = machine_loads(b, r, 8)
    want4 = E.dissatisfaction_from_edges_plain(sp, r, b, loads, sp.speeds,
                                               sp.mu, "c")
    want5 = E.sweep_candidates_from_edges_plain(sp, r, b, loads, sp.speeds,
                                                sp.mu, "c")
    late = torch.full_like(r, 99)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(200_000_000)
        late.copy_(r)
        got4 = E.dissatisfaction_from_edges_cuda(sp, late, b, loads,
                                                 sp.speeds, sp.mu, "c")
        got5 = E.sweep_candidates_from_edges_cuda(sp, late, b, loads,
                                                  sp.speeds, sp.mu, "c")
    s.synchronize()
    for got, want in ((got4, want4), (got5, want5)):
        for a, c in zip(got, want):
            assert torch.equal(a, c)


@pytest.mark.gpu
def test_edge_kernels_raise_on_a_refused_launch(card, monkeypatch):
    """The C entry points refuse K outside [1, 128] and kernel 5 a missing
    scratch with a status, and a wrapper raises RuntimeError on any status
    but 0; the next launch is clean."""
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels import edge_block as E
    sp, r = _sparse_on(card, 300, 4, seed=10)
    b = sp.node_weights
    loads = machine_loads(b, r, 4)
    ins, _scalars = E._inputs(sp, r, b, loads, sp.speeds, sp.mu, None, None,
                              r.device)
    stream = torch.cuda.current_stream().cuda_stream
    f4 = D._entry_point("dissat_from_edges", "edge_block")
    f5 = D._entry_point("sweep_candidates_from_edges", "edge_block")
    dis, best = torch.empty_like(b), torch.empty_like(r)
    n, e = sp.num_nodes, sp.num_edges
    for k in (0, 129):
        assert f4(*ins, dis.data_ptr(), best.data_ptr(), n, e, k, 0,
                  stream) != 0
    a5, _ = E.sweep_candidates_args(ins, n, e, 4, 0, stream, r.device)
    assert f5(*a5[:13], None, *a5[14:]) != 0      # no partials
    args = (sp, r, b, loads, sp.speeds, sp.mu, "c")
    for name in ("dissat_from_edges", "sweep_candidates_from_edges"):
        monkeypatch.setitem(D._entry_points, name, lambda *a: 1)
    with pytest.raises(RuntimeError, match="failed to launch"):
        E.dissatisfaction_from_edges_cuda(*args)
    with pytest.raises(RuntimeError, match="failed to launch"):
        E.sweep_candidates_from_edges_cuda(*args)
    monkeypatch.undo()
    got = E.sweep_candidates_from_edges_cuda(*args)
    want = E.sweep_candidates_from_edges_plain(*args)
    torch.cuda.synchronize()
    for a, c in zip(got, want):
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


def _des_instance(card, max_ticks, seed=1):
    """The DES at n=512, K=8 on the card, refined every 256 ticks; the
    workload from ``seed``.  Returns (config, adjacency, state, schedule)."""
    from repro_torch.core.initial import initial_partition
    from repro_torch.des import engine, scenarios
    from repro_torch.des.workload import flooded_packet_workload
    from repro_torch.graphs.generators import specialized_geometric
    n, k, t = 512, 8, 32
    adj = specialized_geometric(n, 0)
    spec = flooded_packet_workload(adj, seed, num_threads=t,
                                   window_sim_time=60.0, scope=2,
                                   max_per_lp=3)
    cfg = engine.DESConfig(num_lps=n, num_machines=k, num_threads=t,
                           event_capacity=48, history_capacity=96,
                           inter_delay=8, refine_freq=256,
                           refine_max_turns=512, refine_theta_scale=0.5,
                           migration_freeze=0.1, max_ticks=max_ticks)
    m0 = initial_partition(torch.as_tensor(adj, device=card), k, 0)
    state = engine.make_initial_state(cfg, m0, spec.src, spec.time,
                                      spec.count, device=card)
    return cfg, adj, state, scenarios.random_churn(k, 8, 300, seed=2)


def _des_run(card, dissat_fn, max_ticks, graph_ticks=None):
    """:func:`_des_instance` run through ``refine`` with ``dissat_fn``
    (None: kernel 1); ``graph_ticks`` the run loop's CUDA-graph length
    (None: its default; 0: eager ticks)."""
    from repro_torch.des import engine
    cfg, adj, state, churn = _des_instance(card, max_ticks)
    if graph_ticks is None:
        return engine.run_simulation(cfg, adj, state, churn,
                                     dissat_fn=dissat_fn)
    return engine._run_lone(cfg, adj, state, churn, dissat_fn, graph_ticks)


@pytest.mark.gpu
def test_des_kernel_path_bitwise_twin_path(card):
    """The DES refining through kernel 1 reaches, field by field, the
    state it reaches through kernel 1's plain twin."""
    from repro_torch.kernels.ops import make_aggregate_dissat_fn_plain
    D.reset_launches()
    got = _des_run(card, None, 1800)
    launched = D.launches["dissat_from_aggregate"]
    want = _des_run(card, make_aggregate_dissat_fn_plain(), 1800)
    assert int(got.refines) >= 4 and launched > 0
    assert _smoke().des_differ(got, want) == []


@pytest.mark.gpu
def test_des_graph_replayed_ticks_bitwise_eager(card):
    """The run loop's CUDA-graph replay of ticks reaches the state eager
    ticks reach, refinement rounds between the replays included."""
    got = _des_run(card, None, 1100)
    want = _des_run(card, None, 1100, graph_ticks=0)
    assert int(got.refines) >= 4
    assert _smoke().des_differ(got, want) == []


@pytest.mark.gpu
def test_des_fleet_kernel3_path_bitwise_twin_path(card):
    """A fleet of three workloads refining through kernel 3 reaches, field
    by field, the state it reaches through kernel 3's plain twin, and
    never launches kernel 1."""
    from repro_torch.core.batch import stack_pytrees
    from repro_torch.des import engine, scenarios
    from repro_torch.kernels.ops import make_aggregate_dissat_fn_plain
    elements = [_des_instance(card, 1800, seed) for seed in (1, 2, 3)]
    cfg = elements[0][0]
    adjs = torch.stack([torch.as_tensor(e[1]) for e in elements])
    states = stack_pytrees([e[2] for e in elements])
    scheds = scenarios.stack_schedules([e[3] for e in elements])
    D.reset_launches()
    got = engine.run_simulation_batch(cfg, adjs, states, scheds)
    launched = dict(D.launches)
    want = engine.run_simulation_batch(
        cfg, adjs, states, scheds,
        dissat_fn=make_aggregate_dissat_fn_plain(batched=True))
    assert int(got.refines.min()) >= 4
    assert launched["dissat_from_aggregate_batched"] > 0
    assert launched["dissat_from_aggregate"] == 0
    assert _smoke().des_differ(got, want) == []


def _dist_problem(card, n=1000, k=8, seed=3):
    from repro_torch.core.problem import make_problem
    from repro_torch.graphs.generators import (random_degree_graph,
                                               random_weights)
    adj = random_degree_graph(n, seed=seed)
    b, c = random_weights(adj, seed=seed + 1, mean=5.0)
    speeds = np.random.default_rng(seed).uniform(0.5, 2.0, k)
    prob = make_problem(c, b, speeds, mu=8.0, device=card)
    r0 = torch.as_tensor(np.random.default_rng(seed + 2).integers(
        0, k, n).astype(np.int32), device=card)
    return prob, r0


def _same_result(want, got):
    assert torch.equal(want.assignment, got.assignment)
    assert torch.equal(want.loads, got.loads)
    assert int(want.num_moves) == int(got.num_moves)
    assert int(want.num_turns) == int(got.num_turns)
    assert bool(want.converged) == bool(got.converged)


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("num_shards", [1, 3, 8])
def test_distributed_kernel3_bitwise_refine(card, framework, num_shards):
    """The emulated driver reduces every turn's (S, Ns, K) stack with one
    kernel-3 launch and lands on ``refine`` (kernel 1) bitwise; with
    theta too (1000 rows: S = 3 pads the last block)."""
    from repro_torch import distributed as PD
    from repro_torch.core.refine import refine
    prob, r0 = _dist_problem(card)
    for theta in (None, 0.5):
        want = refine(prob, r0, framework, theta=theta)
        D.reset_launches()
        got = PD.refine_distributed(prob, r0, framework,
                                    num_shards=num_shards, theta=theta)
        torch.cuda.synchronize()
        assert D.launches["dissat_from_aggregate"] == 0
        assert D.launches["dissat_from_aggregate_batched"] >= int(
            got.num_turns)
        assert bool(got.converged)
        _same_result(want, got)


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
def test_distributed_recompute_kernel2_bitwise(card, framework):
    """Recompute turns on kernel 2 over the (S*Ns, N) row blocks: bitwise
    the controller's recompute turns on kernel 2 over the whole matrix,
    one launch a turn."""
    from repro_torch import distributed as PD
    from repro_torch.core.refine import refine
    from repro_torch.kernels import ops
    prob, r0 = _dist_problem(card)
    want = refine(prob, r0, framework, max_turns=120,
                  cost_matrix_fn=ops.make_core_cost_matrix_fn())
    D.reset_launches()
    got = PD.refine_distributed(prob, r0, framework, num_shards=3,
                                max_turns=120, incremental=False,
                                cost_fn="pallas")
    torch.cuda.synchronize()
    assert D.launches["cost_matrix"] == 120
    _same_result(want, got)


@pytest.mark.gpu
def test_distributed_collective_nccl_group_of_one(card):
    """The collective driver on a one-rank NCCL group it makes and
    destroys itself: kernel 1 each turn, bitwise the emulated driver."""
    import torch.distributed as dist
    from repro_torch import distributed as PD
    prob, r0 = _dist_problem(card)
    want = PD.refine_distributed(prob, r0, "c", num_shards=8)
    D.reset_launches()
    got, wire = PD.refine_distributed_shard_map(prob, r0, "c", num_shards=1,
                                                measure_wire=True)
    torch.cuda.synchronize()
    assert not dist.is_initialized()
    assert D.launches["dissat_from_aggregate"] >= int(got.num_turns)
    assert D.launches["dissat_from_aggregate_batched"] == 0
    _same_result(want, got)
    assert wire.payload_bytes == 16 * int(got.num_turns)


@pytest.mark.gpu
def test_recorder_on_paths_bitwise_recorder_off(card):
    """On the card, every runtime under a recorder returns its
    recorder-free result bitwise, and records its run (n=512)."""
    from repro_torch import distributed as PD
    from repro_torch.core.refine import refine, refine_sweeps, refine_traced
    from repro_torch.des import engine
    from repro_torch.obs import Recorder
    from repro_torch.obs.report import check_run, replay_run
    prob, r0 = _dist_problem(card, n=512)
    for framework in ("c", "ct"):
        rec = Recorder()
        got = refine(prob, r0, framework, recorder=rec)
        _same_result(refine(prob, r0, framework), got)
        assert sum(e["kind"] == "turn" for e in rec.events) == int(
            got.num_turns)
        if framework == "c":
            assert check_run(replay_run(rec.events)) == []
        want, wtr = refine_traced(prob, r0, framework, max_turns=256)
        got, gtr = refine_traced(prob, r0, framework, max_turns=256,
                                 recorder=Recorder())
        _same_result(want, got)
        assert all(torch.equal(a, b) for a, b in zip(wtr, gtr))
        want, wout = refine_sweeps(prob, r0, framework, max_sweeps=32)
        got, gout = refine_sweeps(prob, r0, framework, max_sweeps=32,
                                  recorder=Recorder())
        _same_result(want, got)
        assert all(torch.equal(a, b) for a, b in zip(wout, gout))
        rec = Recorder()
        got = PD.refine_distributed(prob, r0, framework, num_shards=8,
                                    recorder=rec)
        _same_result(PD.refine_distributed(prob, r0, framework,
                                           num_shards=8), got)
        assert [e for e in rec.events if e["kind"] == "wire"][0]["ok"]
    cfg, adj, state, churn = _des_instance(card, 1100)
    rec = Recorder()
    got = engine.run_simulation(cfg, adj, state, churn, recorder=rec)
    want = engine.run_simulation(cfg, adj, state, churn)
    assert int(got.refines) >= 4
    assert _smoke().des_differ(got, want) == []
    assert sum(e["kind"] == "des_refine" for e in rec.events) == int(
        got.refines)


def _des_events(engine, cfg, adj, state, churn, graph_ticks):
    """A recorded lone run with CUDA graphs of ``graph_ticks`` ticks (0:
    eager): (final state, its events without the timed fields)."""
    from repro_torch.obs import Recorder
    rec = Recorder()
    final = engine._run_lone(cfg, adj, state, churn, None, graph_ticks,
                             recorder=rec)
    return final, [{k: v for k, v in e.items()
                    if k not in ("ts", "dur", "wall")}
                   for e in rec.events if e["kind"] != "phase"]


@pytest.mark.gpu
def test_des_graph_replayed_tick_rows_equal_eager(card):
    """The tick rows the CUDA graphs' captured steps write equal the rows
    eager ticks write, refinement rows and final counters too."""
    from repro_torch.des import engine
    cfg, adj, state, churn = _des_instance(card, 1100)
    graphed = _des_events(engine, cfg, adj, state, churn, 16)
    eager = _des_events(engine, cfg, adj, state, churn, 0)
    assert _smoke().des_differ(graphed[0], eager[0]) == []
    ticks = [e for e in graphed[1] if e["kind"] == "tick"]
    assert len(ticks) == 1100 // cfg.trace_stride
    assert sum(e["kind"] == "des_refine" for e in graphed[1]) >= 4
    assert graphed[1] == eager[1]


@pytest.mark.gpu
@pytest.mark.parametrize("start", ["stride 1", "a tick before the stride"])
def test_des_graph_warm_up_writes_no_tick_row(card, start):
    """The graph's warm-up tick is not one of the run's: where it lands
    on the ``trace_stride`` cadence — every tick at stride 1, or the first
    tick of a run resumed one tick before the cadence — the replayed run
    still writes each tick's row once, as the eager run does."""
    import dataclasses
    from repro_torch.des import engine
    cfg, adj, state, churn = _des_instance(card, 600)
    if start == "stride 1":
        cfg = dataclasses.replace(cfg, trace_stride=1)
    else:
        state = engine._run_lone(
            dataclasses.replace(cfg, max_ticks=cfg.trace_stride - 1), adj,
            state, churn, None, 0)
        assert int(state.tick) == cfg.trace_stride - 1
    graphed = _des_events(engine, cfg, adj, state, churn, 16)
    eager = _des_events(engine, cfg, adj, state, churn, 0)
    assert _smoke().des_differ(graphed[0], eager[0]) == []
    ticks = [e["t"] for e in graphed[1] if e["kind"] == "tick"]
    assert ticks and len(ticks) == len(set(ticks))
    assert graphed[1] == eager[1]


@pytest.mark.gpu
def test_recorder_adds_only_its_reads_of_the_card(card):
    """Host syncs (``torch.cuda.set_sync_debug_mode``): ``refine`` under
    a recorder makes at most two more than without (its reads of the
    replay seed before the loop and of the rows and the result after
    it), the DES at most one more (its rows and counters at the end) —
    none a turn or a tick."""
    from repro_torch.core.refine import refine
    from repro_torch.des import engine
    from repro_torch.obs import Recorder
    smoke = _smoke()
    prob, r0 = _dist_problem(card, n=512)
    refine(prob, r0, "c")
    off, _, n_off, where_off = smoke.count_syncs(
        lambda: refine(prob, r0, "c"))
    on, _, n_on, where_on = smoke.count_syncs(
        lambda: refine(prob, r0, "c", recorder=Recorder()))
    _same_result(off, on)
    extra = where_on - where_off
    assert n_off > 0 and sum(extra.values()) <= 2
    assert all(where.startswith("rows.py:") for where in extra)
    cfg, adj, state, churn = _des_instance(card, 1100)
    adj = torch.as_tensor(adj, device=card)
    _, _, n_off, _ = smoke.count_syncs(
        lambda: engine.run_simulation(cfg, adj, state, churn))
    _, _, n_on, _ = smoke.count_syncs(
        lambda: engine.run_simulation(cfg, adj, state, churn,
                                      recorder=Recorder()))
    assert n_off > 0 and 0 <= n_on - n_off <= 1


# ---------------------------------------------------------------------------
# the MoE and hybrid families: kernel path against plain path
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-235b-a22b", "zamba2-7b"])
def test_moe_and_hybrid_kernel_path_matches_plain_path(card, arch):
    """Smoke configs (f32 compute) on the card: a prefill of 33 tokens and
    7 decode steps on the kernel path (kernels 6-7, and 8 for the hybrid)
    against the same on the plain path: logits within 1e-4, the greedy
    tokens equal, each kernel launched once a layer it serves."""
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ssd_scan as S8
    from repro_torch.models import transformer as T

    cfg = configs.get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    out = {}
    for path in ("kernel", "plain"):
        for mod in (A, F, S8):
            mod.reset_launches()
        last, cache = T.prefill(params, cfg, tokens[:, :33], max_len=48,
                                attention=path, ssm=path)
        logits = [last]
        for i in range(33, 40):
            step, cache = T.decode_step(params, cfg, tokens[:, i:i + 1],
                                        cache, attention=path)
            logits.append(step)
        torch.cuda.synchronize()
        out[path] = torch.cat(logits, dim=1)
        launches = {**A.launches, **F.launches, **S8.launches}
        mamba = cfg.family == "hybrid"
        want = {"flash_attention": cfg.attention_layers,
                "decode_attention": cfg.attention_layers * 7,
                "ssd_scan": cfg.num_layers if mamba else 0}
        if path == "plain":
            want = dict.fromkeys(want, 0)
        assert launches == want, (path, launches)
    torch.testing.assert_close(out["kernel"], out["plain"], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out["kernel"].argmax(-1), out["plain"].argmax(-1))


@pytest.mark.gpu
def test_moe_block_scatter_matches_dense_on_the_card(card):
    """granite's expert layout (32 experts, top-8) at a narrow width, f32:
    scatter at capacity 8.0 against the dense oracle and against einsum at
    a capacity that drops, within 1e-4; equal statistics; and the scatter
    path makes no host sync (``set_sync_debug_mode("error")``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(
        configs.get_smoke_config("granite-moe-1b-a400m"), d_model=256,
        d_ff=128, num_experts=32, top_k=8, moe_group_size=64)
    params = M.init_moe(torch.Generator(device=card).manual_seed(0), cfg)
    x = torch.randn((2, 150, cfg.d_model), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))

    def run(impl, capacity, **kw):
        return M.moe_block(params, dataclasses.replace(
            cfg, moe_impl=impl, capacity_factor=capacity), x, **kw)

    y_dense, st_dense = run("dense", 1.0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y_ample, st_ample = run("scatter", 8.0)
        y_drop, _ = run("scatter", 0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    y_einsum, _ = run("einsum", 0.5)
    torch.testing.assert_close(y_ample, y_dense, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y_drop, y_einsum, rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(st_ample, st_dense))
    _, ids, _ = M._route(params, cfg, x.reshape(-1, cfg.d_model))
    plan = M._dispatch(ids, dataclasses.replace(cfg, capacity_factor=0.5),
                       dropless=False)
    assert int(plan.keep.sum()) < ids.numel()        # 0.5 drops pairs
    assert not torch.equal(y_drop, y_ample)


# ---------------------------------------------------------------------------
# training: the kernel path's gradients, determinism, resume, the planner
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-moe-1b-a400m",
                                  "mamba2-1.3b", "zamba2-7b"])
def test_train_kernel_path_gradients_match_plain_path(card, arch):
    """Smoke configs at f32 compute on the card: ``forward_train``'s loss
    and every gradient with kernels 7/8 in the forward (the plain formula
    backward) against the twins under autograd, within 1e-4 of each leaf's
    largest magnitude; the kernel path launches each kernel twice a layer
    (remat) and calls no twin."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ssd_scan as S8
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticDataConfig, synthetic_batch
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import flatten

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype="float32")
    params = T.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    batch = synthetic_batch(SyntheticDataConfig(
        vocab_size=cfg.vocab_size, seq_len=96, global_batch=2), 0,
        device=card)
    for mod in (F, S8):
        mod.reset_launches()
    lk, _, gk = value_and_grad(params, cfg, batch)
    mamba = cfg.family in ("ssm", "hybrid")
    assert F.launches == {"flash_attention": 2 * cfg.attention_layers}
    assert S8.launches == {"ssd_scan": 2 * cfg.num_layers if mamba else 0}
    assert not any(F.twin_calls.values()) and not any(S8.twin_calls.values())
    lp, _, gp = value_and_grad(params, cfg, batch, attention="plain",
                               ssm="plain")
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for path, a, b in zip(*flatten(gk), flatten(gp)[1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), \
            path


@pytest.mark.gpu
def test_train_steps_on_the_card_are_deterministic(card):
    """Three bf16-compute steps of the MoE smoke config from one state,
    twice: bitwise equal states (the embedding's and the MoE gathers'
    backward accumulate in a fixed order)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.training.data import SyntheticDataConfig, synthetic_batch
    from repro_torch.training.train_step import (TrainHyper, init_train_state,
                                                 make_train_step)
    from repro_torch.training.tree import flatten

    cfg = dataclasses.replace(configs.get_smoke_config(
        "granite-moe-1b-a400m"), compute_dtype="bfloat16")
    step = make_train_step(cfg, TrainHyper(total_steps=10, warmup=1))
    data = SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                               global_batch=4)
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, 0, device=card)
        for i in range(3):
            state, _ = step(state, synthetic_batch(data, i, device=card))
        runs.append(flatten(state))
    for path, a, b in zip(*runs[0], runs[1][1]):
        assert torch.equal(a, b), path


@pytest.mark.gpu
def test_train_driver_resumes_bitwise_on_the_card(card, tmp_path):
    """``launch.train`` on the card: 4 steps with checkpoints every 2 and
    replans every 2 (kernel 1), the step-4 checkpoint taken away, a fresh
    run resumes at step 2 and ends bitwise on the uninterrupted state."""
    import os

    from repro_torch.kernels import dissatisfaction as D
    from repro_torch.launch.train import train
    from repro_torch.training.tree import flatten

    kw = dict(steps=4, global_batch=4, seq_len=64, replan=2, groups=2,
              device="cuda")
    d = str(tmp_path / "ckpt")
    D.reset_launches()
    straight, losses = train("granite-moe-1b-a400m", ckpt_dir=d,
                             ckpt_every=2, **kw)
    assert D.launches["dissat_from_aggregate"] > 0
    os.rename(os.path.join(d, "step_00000004"), str(tmp_path / "step4"))
    resumed, tail = train("granite-moe-1b-a400m", ckpt_dir=d,
                          ckpt_every=100, **kw)
    assert tail == losses[2:]
    for path, a, b in zip(*flatten(straight), flatten(resumed)[1]):
        assert a.device.type == "cuda" and torch.equal(a, b), path


@pytest.mark.gpu
def test_planner_on_the_card_equals_the_cpu(card):
    """``expert_placement`` (kernel 1 each refinement turn) and
    ``stage_assignment`` on the card give the CPU twin path's
    permutation, assignment and moves."""
    from repro_torch.kernels import dissatisfaction as D
    from repro_torch.sharding import expert_placement, stage_assignment

    rng = np.random.default_rng(0)
    load = rng.uniform(0.01, 0.3, 32).astype(np.float32)
    coact = rng.uniform(0, 50, (32, 32)).astype(np.float32)
    coact = np.triu(coact, 1)
    coact = coact + coact.T
    current = np.arange(32, dtype=np.int32) // 8
    D.reset_launches()
    got = expert_placement(torch.from_numpy(load).to(card),
                           torch.from_numpy(coact).to(card), 4,
                           current=torch.from_numpy(current).to(card))
    assert D.launches["dissat_from_aggregate"] > 0
    want = expert_placement(torch.from_numpy(load), torch.from_numpy(coact),
                            4, current=torch.from_numpy(current))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert got[2]["moves"] == want[2]["moves"]
    cost = rng.uniform(1.0, 3.0, 24).astype(np.float32)
    a, game, dp = stage_assignment(cost, 128.0, 4)
    b, game_cpu, dp_cpu = stage_assignment(cost, 128.0, 4, device="cpu")
    assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert (game, dp) == (game_cpu, dp_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", [0, 50])
def test_sample_logits_distribution_on_the_card(card, top_k):
    """2^17 card draws of ``sample_logits`` from one logits row at T = 0.8:
    the total-variation distance from softmax(logits / T) (top-k kept as
    the sampler keeps it) within ``chip_smoke.sampling_tv``'s bound, which
    fails with probability below 10^-6; no draw outside the top-k; the
    same generator seed draws the same tokens."""
    from repro_torch.serving.sampler import sample_logits
    smoke = _smoke()
    g = torch.Generator(device="cpu").manual_seed(28)
    row = (3.0 * torch.randn(1024, generator=g)).to(card)
    gen = torch.Generator(device=card).manual_seed(28)
    tv, bound, outside = smoke.sampling_tv(gen, row, 0.8, top_k, 2 ** 17)
    assert tv <= bound and outside == 0, (tv, bound, outside)
    draws = [sample_logits(torch.Generator(device=card).manual_seed(5),
                           row[None].expand(64, 1024), temperature=0.8,
                           top_k=top_k) for _ in range(2)]
    assert draws[0].device.type == "cuda" and draws[0].dtype == torch.int32
    assert torch.equal(draws[0], draws[1])


@pytest.mark.gpu
def test_analysis_allocator_fits_match_the_table(card):
    """``chip_smoke.py`` phase 29 (b): every entry point's ``mem_device``
    exponents at the full grid on the card — the caching allocator's peak
    during set-up plus one turn — within its declared ``mem`` budget plus
    ``EXPONENT_TOL`` and within ``EXPECTATION_TOL`` of ``complexity.json``'s
    ``full/cuda`` section; kernels 1, 3 and 4 launched on the way."""
    from repro_torch.analysis import complexity_rules as cx
    from repro_torch.analysis import entrypoints
    from repro_torch.kernels import edge_block as E
    cx.profile_entry_point.cache_clear()           # run them here
    entrypoints.trace_entry_point_sized.cache_clear()
    D.reset_launches()
    E.reset_launches()
    table = cx.load_table()["grids"]["full/cuda"]
    profiles = cx.all_profiles("full", "cuda")
    assert set(profiles) == {e.name
                             for e in entrypoints.registered_entry_points()}
    for name, prof in profiles.items():
        budget = cx.declared_budget(entrypoints.entry_point(name))["mem"]
        fits = prof["fits"]["mem_device"]
        assert set(fits) == set(prof["fits"]["mem"]), name
        for dim, got in fits.items():
            assert got <= budget[dim] + cx.EXPONENT_TOL, (name, dim, got)
            want = table[name]["fits"]["mem_device"][dim]
            assert abs(got - want) <= cx.EXPECTATION_TOL, (name, dim, got)
    launched = {**D.launches, **E.launches}
    for name in ("dissat_from_aggregate", "dissat_from_aggregate_batched",
                 "dissat_from_edges"):
        assert launched[name] > 0, name


@pytest.mark.gpu
def test_analysis_finds_nothing_new_on_the_card(card):
    """Every rule family at the full grid on the card reports only the
    port's baseline."""
    from repro_torch.analysis import (AnalysisContext, load_baseline,
                                      run_rules, split_findings)
    findings = run_rules(AnalysisContext(device="cuda"))
    new, _, stale = split_findings(findings, load_baseline())
    assert new == [], [f.id for f in new]
    assert stale == set()


def _fleet_on(card, rep, num=4, k=4):
    """A fleet on the card: dense elements from ``random_degree_graph(45,
    seed=s)`` (45 rows: the stack's element rows start off the 16-byte
    grid), sparse ones one ``random_degree_graph_edges(301, seed=0)`` with
    per-element weights; speeds and starts from ``default_rng(40 + s)``."""
    from repro_torch.core.problem import make_problem
    from repro_torch.core.sparse import make_sparse_problem
    from repro_torch.graphs.generators import (random_degree_graph,
                                               random_degree_graph_edges,
                                               random_weights,
                                               random_weights_edges)
    n = 45 if rep == "dense" else 301
    if rep == "sparse":
        snd, rcv = random_degree_graph_edges(n, seed=0)
    problems, r0s = [], []
    for s in range(num):
        rng = np.random.default_rng(40 + s)
        speeds = rng.uniform(0.5, 2.0, k)
        if rep == "dense":
            b, c = random_weights(random_degree_graph(n, seed=s), seed=s + 7,
                                  mean=5.0)
            problems.append(make_problem(c, b, speeds, mu=8.0, device=card))
        else:
            b, w = random_weights_edges(n, snd, seed=s + 7, mean=5.0)
            problems.append(make_sparse_problem(snd, rcv, w, b, speeds,
                                                mu=8.0, device=card))
        r0s.append(torch.as_tensor(rng.integers(0, k, n).astype(np.int32),
                                   device=card))
    return problems, r0s


def _same_element(batch, lone, fleet, b, label):
    """Every tensor of ``lone`` equals element b of ``fleet``, bitwise,
    dtype included."""
    got = batch._tensors(batch.unstack_pytree(fleet, b))
    want = batch._tensors(lone)
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (label, b, i)
        assert torch.equal(g, w), (label, b, i)


@pytest.mark.gpu
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_fleet_one_loop_bitwise_lone_runs_on_the_card(card, rep, framework,
                                                      monkeypatch):
    """The batched sweep modes and the recompute path, each one loop over
    the stack, equal every element's lone run bitwise on the card: the §4.5
    mode, top-2 and unbounded sweeps with coins (each generator ending in
    its lone run's state), unbounded sweeps with the mover buffer's cap
    lowered to 8 (rebuilds beside buffers), recompute turns, and the
    incremental turns (kernel 3 against each lone run's kernel 1) whose
    per-element set-up reads the same slices; element 0 starts at an
    equilibrium of ``refine``, ct runs with a per-node θ."""
    from repro_torch.core import batch
    from repro_torch.core import refine as R
    problems, r0s = _fleet_on(card, rep)
    r0s[0] = R.refine(problems[0], r0s[0], framework).assignment
    stacked, r0 = batch.stack_problems(problems), torch.stack(r0s)
    theta = None
    if framework == "ct":
        theta = torch.as_tensor(np.random.default_rng(9).uniform(
            0, 3, tuple(r0.shape)).astype(np.float32), device=card)

    def th(b):
        return None if theta is None else theta[b]

    def gens():
        return [torch.Generator(device=card).manual_seed(3 + b)
                for b in range(len(problems))]

    coins = dict(move_prob=0.5, epsilon=1e-3)
    for kw in (None, dict(moves_per_machine=2, **coins),
               dict(moves_per_machine=None, **coins), "cap"):
        if kw == "cap":
            monkeypatch.setattr(R, "_UNBOUNDED_APPLY_CAP", 8)
            kw = dict(moves_per_machine=None)
        g = gens() if kw and "move_prob" in kw else None
        if kw is None:
            fleet = batch.refine_simultaneous_batched(
                stacked, r0, framework, max_sweeps=64, theta=theta)
        else:
            fleet = batch.refine_sweeps_batched(
                stacked, r0, framework, max_sweeps=64, theta=theta,
                generators=g, **kw)
        for b, (p, start) in enumerate(zip(problems, r0s)):
            lone_g = None if g is None else gens()[b]
            if kw is None:
                lone = R.refine_simultaneous(p, start, framework,
                                             max_sweeps=64, theta=th(b))
            else:
                lone = R.refine_sweeps(p, start, framework, max_sweeps=64,
                                       theta=th(b), generator=lone_g, **kw)
            _same_element(batch, lone, fleet, b, f"{rep} {kw}")
            if g is not None:
                assert torch.equal(g[b].get_state(), lone_g.get_state())
    monkeypatch.undo()
    for incremental in (False, True):
        res = batch.refine_batched(stacked, r0, framework, max_turns=400,
                                   incremental=incremental, theta=theta)
        trace = batch.refine_traced_batched(stacked, r0, framework,
                                            max_turns=40,
                                            incremental=incremental,
                                            theta=theta)
        for b, (p, start) in enumerate(zip(problems, r0s)):
            label = f"{rep} incremental={incremental}"
            _same_element(batch, R.refine(p, start, framework, max_turns=400,
                                          incremental=incremental,
                                          theta=th(b)), res, b, label)
            _same_element(batch, R.refine_traced(
                p, start, framework, max_turns=40, incremental=incremental,
                theta=th(b)), trace, b, f"{label} traced")
