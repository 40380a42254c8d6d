"""The port's cluster moves (paper §7, DESIGN.md §17.3) against the JAX
reference, on the CPU: h-hop masks on both representations, the joint
cluster-move pass, and the cluster update of the carried aggregate.

Masks, accepted moves and assignments must match exactly; the sparse
cluster update of the aggregate is bitwise the reference's (each row's
edges summed in edge order), the dense one within 1e-5 (a matrix-vector
product summed in each library's own order); potentials to 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import aggregate as jagg
from repro.core import cluster as jcluster
from repro.core.problem import make_problem as j_make_problem
from repro.core.sparse import sparse_from_dense as j_sparse_from_dense
from repro.graphs.generators import random_degree_graph, random_weights
from repro_torch.core import aggregate as agg_mod
from repro_torch.core import cluster, costs
from repro_torch.core.problem import problem_from_arrays

from test_torch_sparse import port_of

torch.set_num_threads(1)

REL = 1e-5


def _instance(n=60, k=4, seed=0):
    """The reference's cluster-test instance on both packages:
    {"dense": (ref, port), "sparse": (ref, port)} and r0."""
    adj = random_degree_graph(n, seed=seed, dmin=2, dmax=4)
    b, c = random_weights(adj, seed=seed + 1, mean=5.0)
    jp = j_make_problem(c, b, np.linspace(0.5, 2.0, k), mu=8.0)
    dense = problem_from_arrays(np.asarray(jp.adjacency),
                                np.asarray(jp.node_weights),
                                np.asarray(jp.speeds), np.asarray(jp.mu),
                                device="cpu")
    jsp = j_sparse_from_dense(jp)
    r0 = np.random.default_rng(seed + 2).integers(0, k, n).astype(np.int32)
    return {"dense": (jp, dense), "sparse": (jsp, port_of(jsp))}, r0


@pytest.mark.parametrize("seed,node,hops", [(0, 0, 1), (1, 17, 2),
                                            (2, 59, 3), (3, 30, 0)])
def test_h_hop_mask_dense_equals_sparse_and_reference(seed, node, hops):
    probs, _ = _instance(seed=seed)
    masks = {rep: cluster.h_hop_mask(port, node, hops).numpy()
             for rep, (_, port) in probs.items()}
    np.testing.assert_array_equal(masks["dense"], masks["sparse"])
    jp = probs["dense"][0]
    want = jcluster.h_hop_mask(jp, jnp.int32(node), hops)
    np.testing.assert_array_equal(masks["dense"], np.asarray(want))
    assert masks["dense"][node]


@pytest.mark.parametrize("hops", [1, 2])
@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_cluster_move_pass_matches_reference(rep, framework, hops):
    """Over a few instances: the same move accepted (or none), the same
    assignment, the gain within 1e-5 — and the port's dense and sparse
    passes agree."""
    moved = 0
    for seed in range(3):
        probs, r0 = _instance(seed=seed)
        jp, port = probs[rep]
        want = jcluster.cluster_move_pass(jp, jnp.asarray(r0), framework,
                                          hops=hops)
        got = cluster.cluster_move_pass(port, r0, framework, hops=hops)
        assert bool(got.moved) == bool(want.moved)
        np.testing.assert_array_equal(got.assignment.numpy(),
                                      np.asarray(want.assignment))
        np.testing.assert_allclose(float(got.gain), float(want.gain),
                                   rtol=1e-4, atol=1e-2)
        other = cluster.cluster_move_pass(
            probs["sparse" if rep == "dense" else "dense"][1], r0,
            framework, hops=hops)
        assert torch.equal(other.assignment, got.assignment)
        moved += bool(got.moved)
    assert moved >= 1


@pytest.mark.parametrize("framework", ["c", "ct"])
@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_cluster_move_descends(rep, framework):
    """An accepted cluster move lowers the global potential by its gain."""
    probs, r0 = _instance(seed=5)
    port = probs[rep][1]
    res = cluster.cluster_move_pass(port, r0, framework, hops=1)
    assert bool(res.moved)
    before = float(costs.global_cost(port, torch.from_numpy(r0), framework))
    after = float(costs.global_cost(port, res.assignment, framework))
    assert after < before
    np.testing.assert_allclose(before - after, float(res.gain), rtol=1e-3)


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_apply_cluster_move_matches_rebuild_and_reference(rep):
    probs, r0 = _instance(seed=1)
    jp, port = probs[rep]
    rt = torch.from_numpy(r0)
    total = torch.sum(port.node_weights)
    agg = agg_mod.init_aggregate_state(port, rt)
    seed_node = 7
    source = int(r0[seed_node])
    dest = (source + 1) % port.num_machines
    mask = cluster.h_hop_mask(port, seed_node, 1) & (rt == source)

    out = agg_mod.apply_cluster_move(port, agg, mask, source, dest, True,
                                     total)
    oracle = agg_mod.rebuild_state(port, torch.where(mask, dest, rt), total)
    assert torch.equal(out.assignment, oracle.assignment)
    np.testing.assert_allclose(out.aggregate.numpy(),
                               oracle.aggregate.numpy(), rtol=REL, atol=1e-4)
    np.testing.assert_allclose(out.loads.numpy(), oracle.loads.numpy(),
                               rtol=REL)
    for field in ("c0", "ct0"):
        np.testing.assert_allclose(float(getattr(out, field)),
                                   float(getattr(oracle, field)), rtol=REL)

    want = jagg.apply_cluster_move(
        jp, jagg.init_aggregate_state(jp, jnp.asarray(r0)),
        jnp.asarray(mask.numpy()), jnp.int32(source), jnp.int32(dest),
        jnp.asarray(True), jnp.sum(jp.node_weights))
    np.testing.assert_array_equal(out.assignment.numpy(),
                                  np.asarray(want.assignment))
    if rep == "sparse":
        np.testing.assert_array_equal(out.aggregate.numpy(),
                                      np.asarray(want.aggregate))
    else:
        np.testing.assert_allclose(out.aggregate.numpy(),
                                   np.asarray(want.aggregate), rtol=REL,
                                   atol=1e-4)
    kept = agg_mod.apply_cluster_move(port, agg, mask, source, dest, False,
                                      total)
    for a, b in zip(kept, agg):
        assert torch.equal(a, b)
