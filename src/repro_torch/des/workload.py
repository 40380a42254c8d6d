"""Limited-scope flooded packet-flow workload with moving hot spots (§6.1).

"Packets are generated at random times by randomly chosen LPs and these
packets flood the network for a limited number of hops ... we generate
'hot spots' of traffic or a cluster of nodes that generate large amounts of
traffic over a short period of (simulation) time.  The locations of these
hot spots change regularly."

Host-side (numpy) generation: a ThreadSpec is pure data fed to
``make_initial_state``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ThreadSpec:
    src: np.ndarray    # (T,) int32 — source LP of each flood thread
    time: np.ndarray   # (T,) float32 — simulation timestamp of injection
    count: np.ndarray  # (T,) int32 — flood scope (hop budget)


def _k_hop_cluster(adj: np.ndarray, center: int, hops: int) -> np.ndarray:
    mask = np.zeros(adj.shape[0], bool)
    mask[center] = True
    nbr = adj > 0
    for _ in range(hops):
        mask = mask | (mask @ nbr)
    return np.flatnonzero(mask)


def flooded_packet_workload(adj: np.ndarray, seed, *,
                            num_threads: int = 96,
                            num_windows: int = 4,
                            window_sim_time: float = 40.0,
                            scope: int | np.ndarray = 3,
                            hotspot_hops: int = 2,
                            hotspot_fraction: float = 0.8,
                            max_per_lp: int | None = None) -> ThreadSpec:
    """Generate flood threads concentrated in per-window moving hot spots.

    Window w covers sim time [w*W, (w+1)*W); ``hotspot_fraction`` of its
    threads originate inside a random ``hotspot_hops``-hop cluster whose
    center is re-drawn every window (the paper's moving hot spot), the rest
    uniformly.  ``scope`` is the hop budget — a scalar, or (num_threads,)
    per-thread budgets in GENERATION order (thread t of the unsorted
    sequence; the returned arrays are jointly sorted by injection time, so
    ``count`` rides the same permutation as ``src``/``time``).

    ``max_per_lp`` caps same-source threads so initial seeding fits the
    event-list capacity; when the hot-spot draw cannot place a thread
    under the cap (all 32 attempts land on full LPs) it falls back to a
    uniform draw over the LPs with capacity left, and raises ValueError
    only when NO LP has room — rather than silently overflowing:
    ``make_initial_state`` scatters one seed slot per same-source thread,
    and out-of-capacity ``.at[]`` writes would be dropped silently under
    jit.
    """
    rng = np.random.default_rng(seed)
    n = adj.shape[0]
    per_window = num_threads // num_windows
    srcs, times = [], []
    per_lp = np.zeros(n, np.int64)
    cap = max_per_lp if max_per_lp is not None else max(2, num_threads)
    counts = np.broadcast_to(np.asarray(scope, np.int32),
                             (num_threads,)).copy()

    for w in range(num_windows):
        center = int(rng.integers(n))
        cluster = _k_hop_cluster(adj, center, hotspot_hops)
        count_w = per_window if w < num_windows - 1 else \
            num_threads - per_window * (num_windows - 1)
        for _ in range(count_w):
            for _attempt in range(32):
                if rng.random() < hotspot_fraction:
                    s = int(rng.choice(cluster))
                else:
                    s = int(rng.integers(n))
                if per_lp[s] < cap:
                    break
            if per_lp[s] >= cap:
                free = np.flatnonzero(per_lp < cap)
                if free.size == 0:
                    raise ValueError(
                        f"cannot place thread {len(srcs)}: all {n} LPs are "
                        f"at max_per_lp={cap}; raise max_per_lp / "
                        f"event_capacity or lower num_threads")
                s = int(rng.choice(free))
            per_lp[s] += 1
            srcs.append(s)
            times.append(w * window_sim_time + rng.random() * window_sim_time)

    order = np.argsort(np.asarray(times, np.float32), kind="stable")
    return ThreadSpec(
        src=np.asarray(srcs, np.int32)[order],
        time=np.asarray(times, np.float32)[order],
        count=counts[order],
    )
