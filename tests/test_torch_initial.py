"""The port's Appendix-A initial partitioning, and its quickstart.

The port draws from a ``torch.Generator`` where the reference uses
threefry keys, so the random parts are held by properties; the BFS
distances and the Thm. A.1 recursion have no randomness and must equal the
reference exactly.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.initial import bfs_distances as j_bfs_distances
from repro.core.initial import er_cluster_growth as j_er_cluster_growth
from repro_torch.core.initial import (bfs_distances, er_cluster_growth,
                                      expand_partitions, initial_partition,
                                      select_focal_nodes)
from repro_torch.graphs.generators import (erdos_renyi,
                                           preferential_attachment,
                                           random_degree_graph)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _adj(adj):
    return torch.from_numpy(np.array(adj, dtype=np.float32))


@pytest.mark.parametrize("n,seed", [(16, 0), (40, 3), (90, 7)])
def test_bfs_distances_equal_reference(n, seed):
    adj = random_degree_graph(n, seed=seed, dmin=2, dmax=4)
    want = np.asarray(j_bfs_distances(jnp.asarray(adj), jnp.arange(n)))
    got = bfs_distances(_adj(adj), torch.arange(n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bfs_unreachable_is_inf():
    adj = np.zeros((4, 4), np.float32)
    adj[0, 1] = adj[1, 0] = 1.0
    got = bfs_distances(_adj(adj), torch.tensor([0]))
    assert got.tolist() == [[0, 1, 0x3FFFFFFF, 0x3FFFFFFF]]


def test_focal_nodes_distinct_and_far():
    adj = random_degree_graph(80, seed=1, dmin=2, dmax=3)
    focals = select_focal_nodes(_adj(adj), 4, generator=0)
    assert focals.dtype == torch.int32
    assert len(set(focals.tolist())) == 4
    dist = bfs_distances(_adj(adj), focals.long())[:, focals.long()]
    pair = dist.numpy() + np.eye(4, dtype=np.int64) * 10**6
    assert pair.min() >= 2


@pytest.mark.parametrize("gen,kwargs", [
    (random_degree_graph, dict(n=60, seed=2)),
    (preferential_attachment, dict(n=60, seed=2)),
    (erdos_renyi, dict(n=60, p=0.08, seed=2)),
])
def test_initial_partition_covers_graph(gen, kwargs):
    adj = gen(**kwargs)
    owner = initial_partition(_adj(adj), 4, generator=5)
    assert owner.shape == (60,) and owner.dtype == torch.int32
    assert int(owner.min()) >= 0 and int(owner.max()) < 4
    counts = np.bincount(owner.numpy(), minlength=4)
    assert (counts > 0).all()
    assert counts.max() <= 60 * 0.7


def test_initial_partition_is_seeded():
    adj = _adj(random_degree_graph(50, seed=4))
    a = initial_partition(adj, 3, generator=11)
    b = initial_partition(adj, 3, generator=torch.Generator().manual_seed(11))
    assert torch.equal(a, b)


def test_expansion_respects_focals():
    adj = random_degree_graph(40, seed=6)
    owner = expand_partitions(_adj(adj), torch.tensor([0, 13, 27]),
                              generator=1, num_machines=3)
    assert owner[0] == 0 and owner[13] == 1 and owner[27] == 2


def test_expansion_handles_disconnected():
    adj = np.zeros((10, 10), np.float32)
    for a, b in [(0, 1), (1, 2), (5, 6)]:
        adj[a, b] = adj[b, a] = 1.0
    owner = expand_partitions(_adj(adj), torch.tensor([0, 5]), generator=2,
                              num_machines=2)
    assert bool((owner >= 0).all())


def test_er_cluster_growth_equals_reference():
    got = er_cluster_growth(200, 0.03, 6).numpy()
    want = np.asarray(j_er_cluster_growth(200, 0.03, 6))
    np.testing.assert_array_equal(got, want)


def test_quickstart_ends_at_equilibrium():
    """``python -m repro_torch.quickstart --device cpu`` converges and
    reports a zero maximum dissatisfaction."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "converged=True" in out.stdout
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("max dissatisfaction"))
    assert float(line.split(":")[1].split()[0]) <= 1e-6
