"""Kernels 4 and 5's order of operations and launch path, on the CPU.

The CUDA kernels of ``csrc/edge_block.cu`` do not build here; their order
of operations does run here, emulated in numpy/torch: a block of
``E.ROWS`` rows owns one edge range, staged in chunks of ``E.CHUNK`` edges; the machines of a chunk's
receivers are gathered edge-parallel; each row adds its edges of every
chunk in ascending order into K float32 slots from +0.0, a machine outside
[0, K) adding nothing; the slots go through the shared epilogue.  Kernel 5
then elects per tile of ``E.ROWS`` rows by two warp reductions a machine
over (gain, row) keys -- the largest order key of a 32-lane warp, then the
lowest row holding it -- and the warps in order; a block walks tiles b,
b + grid, ... merging their firsts in order, and publishes each machine's
(key, row) into a running maximum of key << 32 | ~row, which the last
block reads.  The emulation is held bitwise
against the twins (which sum window by window and elect by a first
maximum) and, at small N, against the reference's Pallas kernels in
interpret mode within ``tests/test_torch_edge_block.py``'s budget.  The
election alone is held against the old strict-> scan with NaN, -inf,
ties and -_BIG gains.  Beside them: ``check_edge_operands`` on CPU tensors
against an explicit device, the source's constants, and the variants
of ``tools/edge_block_ablation.py`` applying to the source.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro.core import sparse as jsparse
from repro.graphs.generators import (preferential_attachment_edges,
                                     random_degree_graph_edges,
                                     random_weights_edges)
from repro.kernels.edge_block import (dissatisfaction_from_edges_pallas,
                                      sweep_candidates_from_edges_pallas)
from repro_torch.core.problem import machine_loads
from repro_torch.kernels import _build
from repro_torch.kernels import dissatisfaction as D
from repro_torch.kernels import edge_block as E

from test_torch_edge_block import ATOL, RTOL, _reference
from test_torch_sparse import port_of

torch.set_num_threads(1)

CPU = torch.device("cpu")
SOURCE = (_build.CSRC / "edge_block.cu").read_text()
NEG_BIG = np.float32(E.NEG_BIG)
WARP = 32


# ---------------------------------------------------------------------------
# instances
# ---------------------------------------------------------------------------

def _pair(s, r, n, k, seed):
    """(reference sparse problem, port sparse problem, r0) on identical
    bits from an undirected edge list."""
    b, w = random_weights_edges(n, s, seed=seed + 1, mean=5.0)
    jp = jsparse.make_sparse_problem(s, r, w, b, np.linspace(0.5, 2.0, k),
                                     mu=8.0)
    r0 = np.random.default_rng(seed + 2).integers(0, k, n).astype(np.int32)
    return jp, port_of(jp), r0


def ragged(n, k, seed):
    s, r = random_degree_graph_edges(n, seed=seed)
    return _pair(s, r, n, k, seed)


def barabasi(n, k, seed):
    """A preferential-attachment graph: its first nodes are hubs, node 0's
    row the largest, and block 0 holds several chunks' worth of edges."""
    s, r = preferential_attachment_edges(n, seed=seed, m=2)
    return _pair(s, r, n, k, seed)


def star_hub(n, k, seed, hub):
    """A random-degree graph with node 0 joined to nodes 1..hub: a row of
    ``hub`` edges, spanning several chunks of the source's size."""
    s, r = random_degree_graph_edges(n, seed=seed)
    s = np.concatenate([s, np.zeros(hub, s.dtype)])
    r = np.concatenate([r, np.arange(1, hub + 1, dtype=r.dtype)])
    return _pair(s, r, n, k, seed)


def _operands(sp, r0, theta):
    r = torch.from_numpy(r0)
    b = sp.node_weights
    loads = machine_loads(b, r, sp.num_machines)
    th = None if theta is None else torch.full((sp.num_nodes,), theta)
    return r, b, loads, th


# ---------------------------------------------------------------------------
# the kernels' order of operations
# ---------------------------------------------------------------------------

def _row_ends(sp):
    rs = sp.row_start.numpy()
    return rs, np.append(rs[1:], sp.num_edges)


def emulate_aggregate(sp, assignment, k, *, rows=E.ROWS, chunk=E.CHUNK):
    """The (N, K) float32 slots as the kernels fill them: block by block,
    chunk by chunk, each row's edges of a chunk added in ascending order."""
    n, e = sp.num_nodes, sp.num_edges
    beg_all, end_all = _row_ends(sp)
    recv = sp.receivers.numpy()
    w = sp.edge_weights.numpy()
    r = assignment.numpy()
    slots = np.zeros((n, k), np.float32)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        e0 = int(beg_all[r0])
        e1 = int(beg_all[r0 + rows]) if r0 + rows < n else e
        beg, end = beg_all[r0:r1], end_all[r0:r1]
        acc = np.zeros((r1 - r0, k), np.float32)
        for lo in range(e0, e1, chunk):
            hi = min(lo + chunk, e1)
            mach = r[recv[lo:hi]]                 # the edge-parallel gather
            wc = w[lo:hi]
            frm = np.maximum(beg, lo)
            count = np.maximum(np.minimum(end, hi) - frm, 0)
            for p in range(int(count.max(initial=0))):
                live = np.flatnonzero(count > p)
                j = frm[live] + p - lo
                m = mach[j]
                keep = (m >= 0) & (m < k)
                at = (live[keep], m[keep])
                acc[at] = acc[at] + wc[j][keep]
        slots[r0:r1] = acc
    return torch.from_numpy(slots)


def emulate_dissat(sp, assignment, node_weights, loads, speeds, mu,
                   framework, *, theta=None, total_weight=None,
                   rows=E.ROWS, chunk=E.CHUNK):
    """Kernel 4, emulated: the slots, then the shared epilogue."""
    if total_weight is None:
        total_weight = torch.sum(node_weights)
    slots = emulate_aggregate(sp, assignment, loads.shape[0], rows=rows,
                              chunk=chunk)
    return D.reduce_dissat_tile_plain(
        slots, assignment, node_weights, theta, loads, speeds, mu,
        total_weight, framework=framework)


def _order_key(g):
    """``order_key`` of the kernel: the float32 ``g`` (no NaN) as a uint32
    that orders as the floats do, -0 and +0 as one, every key above 0."""
    g = np.where(g == 0, np.float32(0), g).astype(np.float32)
    u = g.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _block_first(key, idx):
    """``warp_first`` over each 32 lanes (the largest key by one warp
    reduction, then the lowest idx among the lanes holding it by a
    second), then ``block_first`` over the warps' firsts in warp order."""
    firsts = []
    for w in range(0, key.size, WARP):
        k, i = key[w:w + WARP], idx[w:w + WARP]
        firsts.append((k.max(), i[k == k.max()].min()))
    bk, bi = firsts[0]
    for k2, i2 in firsts[1:]:
        if k2 > bk or (k2 == bk and i2 < bi):
            bk, bi = k2, i2
    return bk, bi


def emulate_election(dissat, best, owner, k, *, rows=E.ROWS, grid=None):
    """Kernel 5's election and combine over per-row ``(dissat, best,
    owner)`` numpy arrays: (gains f32, picks i32, dests i32), (K,) each.
    ``grid`` blocks (default: one a tile) walk tiles b, b + grid, ...;
    the card's grid is the blocks that fit on it at once."""
    n = dissat.size
    tiles = -(-n // rows)
    grid = tiles if grid is None else min(grid, tiles)
    pad = tiles * rows - n
    d = np.concatenate([dissat, np.zeros(pad, np.float32)])
    own = np.concatenate([owner, np.full(pad, -1, owner.dtype)])
    bst = np.concatenate([best, np.zeros(pad, best.dtype)])
    local = np.arange(rows)
    # each tile's first per machine
    t_key = np.zeros((tiles, k), np.uint64)
    t_row = np.zeros((tiles, k), np.int64)
    t_gain = np.zeros((tiles, k), np.float32)
    t_dest = np.zeros((tiles, k), np.int64)
    for tile in range(tiles):
        sl = slice(tile * rows, (tile + 1) * rows)
        live = local + tile * rows < n
        with np.errstate(invalid="ignore"):
            cand = live & (d[sl] > NEG_BIG)       # NaN compares false
        key = np.where(cand, _order_key(np.where(cand, d[sl], 0)), 0)
        for m in range(k):
            top, j = _block_first(np.where(own[sl] == m, key, 0), local)
            t_key[tile, m], t_row[tile, m] = top, tile * rows + j
            t_gain[tile, m] = d[sl][j] if top else NEG_BIG
            t_dest[tile, m] = bst[sl][j]
    # each block merges its tiles in order: a strictly larger key replaces
    first = np.arange(grid)
    p_key, p_row = t_key[first].copy(), t_row[first].copy()
    p_gain, p_dest = t_gain[first].copy(), t_dest[first].copy()
    for tile in range(grid, tiles):
        b = tile % grid
        up = t_key[tile] > p_key[b]
        p_key[b] = np.where(up, t_key[tile], p_key[b])
        p_row[b] = np.where(up, t_row[tile], p_row[b])
        p_gain[b] = np.where(up, t_gain[tile], p_gain[b])
        p_dest[b] = np.where(up, t_dest[tile], p_dest[b])
    # the running maxima of key << 32 | ~row, then the winners' partials
    top = ((p_key << np.uint64(32))
           | (np.uint64(0xFFFFFFFF) - p_row.astype(np.uint64))).max(axis=0)
    picks = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(
        np.int64)
    blk = picks // rows % grid
    cols = np.arange(k)
    return (torch.from_numpy(p_gain[blk, cols]),
            torch.from_numpy(picks.astype(np.int32)),
            torch.from_numpy(p_dest[blk, cols].astype(np.int32)))


def emulate_sweep(sp, assignment, node_weights, loads, speeds, mu,
                  framework, *, theta=None, total_weight=None, rows=E.ROWS,
                  chunk=E.CHUNK):
    """Kernel 5, emulated."""
    dissat, best = emulate_dissat(
        sp, assignment, node_weights, loads, speeds, mu, framework,
        theta=theta, total_weight=total_weight, rows=rows, chunk=chunk)
    return emulate_election(dissat.numpy(), best.numpy(),
                            assignment.numpy(), loads.shape[0], rows=rows)


# ---------------------------------------------------------------------------
# the emulation against the twins and the Pallas kernels
# ---------------------------------------------------------------------------

# (instance, its arguments, chunk): ragged N at every kind of K instance
# (3 and 128 on the runtime-K one); the BA graph at the source's chunk and
# at 32 edges, where its hub rows span several chunks; a hub of 2500
# edges at the source's chunk; the ragged graph with rows of 64
GRAPHS = {
    "ragged-k3": (ragged, (1003, 3, 11), E.CHUNK, E.ROWS),
    "ragged-k8": (ragged, (1003, 8, 12), E.CHUNK, E.ROWS),
    "ragged-k16": (ragged, (1003, 16, 13), E.CHUNK, E.ROWS),
    "ragged-k128": (ragged, (1003, 128, 14), E.CHUNK, E.ROWS),
    "ba-k8": (barabasi, (3000, 8, 15), E.CHUNK, E.ROWS),
    "ba-k16-chunk32": (barabasi, (3000, 16, 16), 32, E.ROWS),
    "hub-k8": (star_hub, (3000, 8, 17, 2500), E.CHUNK, E.ROWS),
    "ragged-rows64": (ragged, (1003, 8, 18), E.CHUNK, 64),
}


@pytest.fixture(scope="module")
def instances():
    return {}


def _instance(cache, name):
    if name not in cache:
        build, args, _, _ = GRAPHS[name]
        cache[name] = build(*args)
    return cache[name]


@pytest.mark.parametrize("theta", [None, 0.5])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_emulation_bitwise_twins(instances, name, framework, theta):
    """Kernel 4's order == its twin bitwise; kernel 5's == its twin and
    == the first-maximum election from kernel 4's twin."""
    _, sp, r0 = _instance(instances, name)
    _, _, chunk, rows = GRAPHS[name]
    r, b, loads, th = _operands(sp, r0, theta)
    args = (sp, r, b, loads, sp.speeds, sp.mu, framework)
    want = E.dissatisfaction_from_edges_plain(*args, theta=th)
    got = emulate_dissat(*args, theta=th, rows=rows, chunk=chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want5 = E.sweep_candidates_from_edges_plain(*args, theta=th)
    for grid in (None, 3):
        got5 = emulate_election(got[0].numpy(), got[1].numpy(), r0,
                                sp.num_machines, rows=rows, grid=grid)
        for a, c in zip(got5, want5):
            assert torch.equal(a, c.to(a.dtype))
    for a, c in zip(got5, E.elect(want[0], want[1], r, sp.num_machines)):
        assert torch.equal(a, c.to(a.dtype))


def test_hub_rows_span_chunks(instances):
    """The instances do what they are for: the hub's row spans several
    chunks of the source's size, the BA graph's block 0 several chunks,
    and its largest row several chunks of 32."""
    _, hub, _ = _instance(instances, "hub-k8")
    beg, end = _row_ends(hub)
    assert int((end - beg).max()) > 2 * E.CHUNK
    _, ba, _ = _instance(instances, "ba-k8")
    beg, end = _row_ends(ba)
    assert int(beg[E.ROWS]) > 2 * E.CHUNK
    assert int((end - beg).max()) > 3 * 32


@pytest.mark.parametrize("chunk", [4, 8, 100, E.CHUNK])
def test_emulated_slots_do_not_depend_on_the_chunk(instances, chunk):
    """The slots are the window-summed aggregate bit for bit at any chunk
    size: a row straddling chunk boundaries still sums in order."""
    from repro_torch.core.costs import adjacency_aggregate_sparse
    _, sp, r0 = _instance(instances, "ba-k8")
    r = torch.from_numpy(r0)
    want = adjacency_aggregate_sparse(sp, r)
    assert torch.equal(emulate_aggregate(sp, r, 8, chunk=chunk), want)


def _add_at(sp, r, k):
    """Each row's slots summed in ascending edge order by ``np.add.at``
    (unbuffered, in index order), edges on machines outside [0, K)
    left out."""
    m = r[sp.receivers.numpy()]
    keep = (m >= 0) & (m < k)
    out = np.zeros((sp.num_nodes, k), np.float32)
    np.add.at(out, (sp.senders.numpy()[keep], m[keep]),
              sp.edge_weights.numpy()[keep])
    return torch.from_numpy(out)


def test_out_of_range_machines_add_nothing(instances):
    """A receiver on a machine outside [0, K) adds to no slot: the
    emulation equals an in-order sum that leaves those edges out (the
    twin's aggregate takes no such machine), and with every machine in
    range that sum is the twin's aggregate."""
    from repro_torch.core.costs import adjacency_aggregate_sparse
    _, sp, r0 = _instance(instances, "ragged-k8")
    assert torch.equal(_add_at(sp, r0, 8),
                       adjacency_aggregate_sparse(sp, torch.from_numpy(r0)))
    r = r0.copy()
    r[::7] = 8
    r[3::11] = -1
    assert torch.equal(emulate_aggregate(sp, torch.from_numpy(r), 8),
                       _add_at(sp, r, 8))


@pytest.mark.parametrize("framework", ["c", "ct"])
def test_idle_machine_keeps_neg_big(framework):
    """A machine owning no node: gain -_BIG, pick 0, dest best[0], from
    the emulated election as from the twin."""
    _, sp, r0 = ragged(1003, 8, 19)
    r0 = np.where(r0 == 5, 4, r0).astype(np.int32)
    r, b, loads, th = _operands(sp, r0, 0.5)
    args = (sp, r, b, loads, sp.speeds, sp.mu, framework)
    d, best = emulate_dissat(*args, theta=th)
    gains, picks, dests = emulate_election(d.numpy(), best.numpy(), r0, 8)
    assert float(gains[5]) == NEG_BIG
    assert int(picks[5]) == 0 and int(dests[5]) == int(best[0])
    want = E.sweep_candidates_from_edges_plain(*args, theta=th)
    for a, c in zip((gains, picks, dests), want):
        assert torch.equal(a, c.to(a.dtype))


PALLAS = [("ragged", (150, 8, 20)), ("ragged", (300, 3, 21)),
          ("barabasi", (400, 8, 22))]


@pytest.mark.parametrize("theta", [None, 0.5])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("kind,args", PALLAS)
def test_emulation_matches_pallas(kind, args, framework, theta):
    """The emulation vs ``dissatisfaction_from_edges_pallas`` and
    ``sweep_candidates_from_edges_pallas`` (interpret mode): best, picks
    and dests exactly, dissat and gains within rtol 1e-3, atol 1e-2 (the
    reference's MXU one-hot product rounds some products differently)."""
    jp, sp, r0 = {"ragged": ragged, "barabasi": barabasi}[kind](*args)
    r, b, loads, th = _operands(sp, r0, theta)
    got = emulate_dissat(sp, r, b, loads, sp.speeds, sp.mu, framework,
                         theta=th)
    want = _reference(dissatisfaction_from_edges_pallas, jp, r0, loads,
                      framework, th)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    got5 = emulate_election(got[0].numpy(), got[1].numpy(), r0,
                            sp.num_machines)
    want5 = _reference(sweep_candidates_from_edges_pallas, jp, r0, loads,
                       framework, th)
    np.testing.assert_array_equal(got5[1].numpy(), np.asarray(want5[1]))
    np.testing.assert_array_equal(got5[2].numpy(), np.asarray(want5[2]))
    np.testing.assert_allclose(got5[0].numpy(), np.asarray(want5[0]),
                               rtol=RTOL, atol=ATOL)


def _scan_election(dissat, best, owner, k, rows):
    """The election as PR 12's kernel made it: per block, K threads each
    scan the block's rows with a strict >; the (T, K) partials then
    combine by a first maximum over blocks (torch.argmax)."""
    n = dissat.size
    blocks = -(-n // rows)
    part = np.full((blocks, k), NEG_BIG, np.float32)
    node = np.zeros((blocks, k), np.int64)
    dest = np.zeros((blocks, k), np.int64)
    for blk in range(blocks):
        for m in range(k):
            gain, win = NEG_BIG, 0
            for j in range(blk * rows, min(n, (blk + 1) * rows)):
                if owner[j] == m and dissat[j] > gain:
                    gain, win = dissat[j], j - blk * rows
            part[blk, m] = gain
            node[blk, m] = blk * rows + win
            dest[blk, m] = best[blk * rows + win]
    win = torch.argmax(torch.from_numpy(part), dim=0).numpy()
    cols = np.arange(k)
    return part.max(axis=0), node[win, cols], dest[win, cols]


@pytest.mark.parametrize("seed", range(6))
def test_tree_election_equals_strict_scan(seed):
    """The warp-reduction election, the blocks' merge of their tiles and
    the running maxima give the strict-> scan's winner on gains with many
    ties, NaN, -inf, -_BIG exactly and +-0, over ragged tile counts, grids
    of one block to one a tile, and machines owning nothing."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    k = int(rng.choice([1, 3, 8, 16]))
    d = rng.choice(np.array([-1.0, 0.0, -0.0, 2.5, 7.0, np.nan, -np.inf,
                             NEG_BIG, 3e38], np.float32), n)
    d = np.where(rng.random(n) < 0.5, rng.integers(-3, 4, n), d)
    d = d.astype(np.float32)
    owner = rng.integers(0, k, n).astype(np.int32)
    owner[rng.random(n) < 0.1] = k        # a machine outside [0, K)
    best = rng.integers(0, k, n).astype(np.int32)
    for rows, grid in ((E.ROWS, None), (64, None), (E.ROWS, 1), (64, 3)):
        want = _scan_election(d, best, owner, k, rows)
        got = emulate_election(d, best, owner, k, rows=rows, grid=grid)
        np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                      want[0].view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])


# ---------------------------------------------------------------------------
# the operand checks, on CPU tensors
# ---------------------------------------------------------------------------

def _check_args(seed=0, k=4):
    _, sp, r0 = ragged(60, k, seed)
    r, b, loads, _ = _operands(sp, r0, None)
    return sp, r, b, loads, sp.speeds, torch.full((60,), 0.5)


def _bad(kind, t):
    if kind == "dtype":
        return t.double() if t.dtype == torch.float32 else t.long()
    if kind == "shape":
        return t[:-1].contiguous()
    return torch.stack([t, t], dim=-1)[..., 0]        # not contiguous


_WHY = {"dtype": "must be torch", "shape": "must have shape",
        "contiguity": "must be contiguous"}
_SP_FIELDS = ("row_start", "receivers", "edge_weights")


@pytest.mark.parametrize("kind", ["dtype", "shape", "contiguity"])
@pytest.mark.parametrize("name", ["row_start", "receivers", "edge_weights",
                                  "assignment", "node_weights", "speeds",
                                  "theta"])
def test_checks_refuse_each_operand(name, kind):
    """Each operand of kernels 4 and 5 with the wrong dtype, shape or
    layout is refused, named, with the message it had before."""
    import dataclasses
    sp, r, b, loads, speeds, theta = _check_args(seed=1)
    ops = {"assignment": r, "node_weights": b, "speeds": speeds,
           "theta": theta}
    if name in _SP_FIELDS:
        # N is the node weights' length and E the senders': a short
        # row_start, receivers or weights array is refused against them
        sp = dataclasses.replace(sp, **{name: _bad(kind, getattr(sp, name))})
    else:
        ops[name] = _bad(kind, ops[name])
    with pytest.raises(ValueError, match=f"{name} {_WHY[kind]}"):
        E.check_edge_operands(sp, ops["assignment"], ops["node_weights"],
                              loads, ops["speeds"], ops["theta"],
                              device=CPU)


def test_checks_refuse_loads_by_name():
    sp, r, b, loads, speeds, _ = _check_args(seed=2)
    for bad, why in ((loads.double(), "must be torch.float32"),
                     (torch.stack([loads, loads], 1)[:, 0],
                      "must be contiguous")):
        with pytest.raises(ValueError, match=f"loads {why}"):
            E.check_edge_operands(sp, r, b, bad, speeds, device=CPU)
    with pytest.raises(ValueError, match="speeds must have shape"):
        E.check_edge_operands(sp, r, b, loads[:3].contiguous(), speeds,
                              device=CPU)


@pytest.mark.parametrize("k", [0, D.MAX_K + 1])
def test_checks_refuse_k_out_of_range(k):
    sp, r, b, _, _, _ = _check_args(seed=3)
    w = torch.ones(k)
    with pytest.raises(ValueError, match=f"1 <= K <= {D.MAX_K}; got K={k}"):
        E.check_edge_operands(sp, r, b, w, w, device=CPU)


def test_checks_refuse_an_empty_problem():
    import dataclasses
    sp, r, b, loads, speeds, _ = _check_args(seed=4)
    empty = dataclasses.replace(sp, node_weights=b[:0])
    with pytest.raises(ValueError, match="at least one node"):
        E.check_edge_operands(empty, r[:0], b[:0], loads, speeds,
                              device=CPU)


def test_checks_refuse_tensors_on_another_device():
    """CPU operands checked against a CUDA device are refused by name,
    the sparse problem's arrays first."""
    sp, r, b, loads, speeds, _ = _check_args(seed=5)
    with pytest.raises(ValueError, match="row_start must be a tensor on "
                                         "cuda"):
        E.check_edge_operands(sp, r, b, loads, speeds,
                              device=torch.device("cuda"))
    with pytest.raises(ValueError, match="assignment must be a tensor on "
                                         "cpu"):
        E.check_edge_operands(sp, r.numpy(), b, loads, speeds, device=CPU)


def test_checks_return_the_launch_shape():
    sp, r, b, loads, speeds, theta = _check_args(seed=6, k=5)
    got = E.check_edge_operands(sp, r, b, loads, speeds, theta, device=CPU)
    assert got == (60, sp.num_edges, 5)
    assert E.check_edge_operands(sp, r, b, loads, speeds,
                                 device=CPU) == got


def test_wrappers_refuse_cpu_tensors_before_checking():
    """A CPU tensor is refused as such, even with operands the kernels
    would not take: no check runs, and nothing falls back to the twin."""
    sp, r, b, loads, speeds, _ = _check_args(seed=7)
    for fn in (E.dissatisfaction_from_edges_cuda,
               E.sweep_candidates_from_edges_cuda):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            fn(sp, r, b, torch.ones(D.MAX_K + 1), speeds, 8.0, "c")


# ---------------------------------------------------------------------------
# the source's constants
# ---------------------------------------------------------------------------

def test_constants_match_the_kernel_source():
    """ROWS, CHUNK and SPECIALISED_K are the source's kRows, kChunk and
    launch_k's template cases; every other K takes the runtime-K
    instance, <0>; a chunk is a whole number of gathers a thread."""
    rows = int(re.search(r"constexpr int kRows = (\d+);", SOURCE).group(1))
    chunk = int(re.search(r"constexpr int kChunk = (\d+);",
                          SOURCE).group(1))
    assert (rows, chunk) == (E.ROWS, E.CHUNK)
    assert rows % WARP == 0 and chunk % rows == 0
    cases = re.findall(r"case (\d+): return launch<(\d+)>", SOURCE)
    assert [int(a) for a, _ in cases] == list(E.SPECIALISED_K)
    assert all(a == b for a, b in cases)
    assert "default: return launch<0>" in SOURCE


def test_entry_point_signatures_are_declared():
    """Both entry points are in ``_build.SIGNATURES`` with the source's
    argument counts: 10 inputs, kernel 4's two outputs or kernel 5's
    three outputs, partials and ticket, then n, e, k, framework,
    stream."""
    sig = _build.SIGNATURES["edge_block"]
    assert set(sig) == {"dissat_from_edges", "sweep_candidates_from_edges"}
    assert len(sig["dissat_from_edges"]) == 12 + 5
    assert len(sig["sweep_candidates_from_edges"]) == 15 + 5
    for name, argtypes in sig.items():
        body = SOURCE[SOURCE.index(f"int {name}("):]
        body = body[:body.index(")")]
        assert body.count(",") + 1 == len(argtypes)


def test_ablation_variants_apply_to_the_source():
    """Every text variant of ``tools/edge_block_ablation.py`` applies to
    the source as it is and changes it, and the bulk-copy variants bring
    their own copy helper: the shipped source stages by plain loads."""
    import importlib.util
    path = _build.CSRC.parents[3] / "tools" / "edge_block_ablation.py"
    spec = importlib.util.spec_from_file_location("edge_block_ablation",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert "bulk_load_1d" not in SOURCE and "mbar_wait" not in SOURCE
    for name, (_, edits) in tool.VARIANTS.items():
        text = tool._variant_source(SOURCE, edits)
        assert (text == SOURCE) == (name == "kernel"), name
    for name in ("bulk", "bulk_one_stage"):
        text = tool._variant_source(SOURCE, tool.VARIANTS[name][1])
        assert "bulk_load_1d(" in text and "mbar_wait(" in text
        stages = re.search(r"constexpr int kStages = (\d+);", text).group(1)
        assert int(stages) == (2 if name == "bulk" else 1)
