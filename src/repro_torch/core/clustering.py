"""Device clustering (paper: "device clustering ensures long-term
convergence and cross-device personalization") — a copy of
``repro/core/clustering.py`` (numpy only; the port imports nothing of the
reference).

Pods/devices are clustered by telemetry profile (bandwidth mean/var,
latency, straggle factor); each cluster gets a shared compression policy
scale and reliability weight omega.  Plain k-means on the host (numpy) —
this runs once per replan, on a handful of device profiles.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _sort_rank(x: np.ndarray) -> np.ndarray:
    """Lexicographic rank of each row — a permutation-invariant tiebreak.
    Two permutations of the same profile set rank every (identical) row
    the same way, so anything seeded through the ranks is stable under
    input reordering."""
    order = np.lexsort(x.T[::-1])          # sort by col 0, then 1, ...
    rank = np.empty(x.shape[0], np.int64)
    rank[order] = np.arange(x.shape[0])
    return rank


def _argbest(score: np.ndarray, rank: np.ndarray) -> int:
    """Index of the max score, ties broken by lexicographic row rank (NOT
    input position — the input order must never matter)."""
    best = score.max()
    tied = np.flatnonzero(score >= best - 1e-12)
    return int(tied[np.argmin(rank[tied])])


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0,
           init: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """x: (N, F). Returns (assignments (N,), centroids (k, F)).

    Deterministic farthest-point (kmeans++-style maxmin) init, sort-stable:
    the first centroid is the lexicographically smallest row and each next
    one the point farthest from the chosen set, so the SAME profile set in
    ANY order yields the same centroids and the same partition (``seed``
    is accepted for API compatibility but unused).  ``init`` warm-starts
    Lloyd's iterations from previous centroids (the ClusterState re-cluster
    path), skipping the init scan.  A cluster that loses all members is
    re-seeded from the point worst served by the surviving centroids
    instead of keeping its stale centroid forever."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    k = min(k, n)
    rank = _sort_rank(x)
    if init is not None and init.shape == (k, x.shape[1]):
        cent = np.array(init, np.float64)
    else:
        # maxmin init: lexicographically-first row, then repeatedly the
        # point with the largest distance to its nearest chosen centroid
        cent = [x[_argbest(np.zeros(n), rank)]]
        for _ in range(1, k):
            d2 = np.min([np.sum((x - c) ** 2, axis=1) for c in cent],
                        axis=0)
            cent.append(x[_argbest(d2, rank)])
        cent = np.stack(cent)
    assign = np.full(n, -1, np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if np.all(new_assign == assign):
            break
        assign = new_assign
        for j in range(k):
            m = assign == j
            if m.any():
                cent[j] = x[m].mean(0)
            else:
                # empty cluster: re-seed from the farthest point (the one
                # worst represented by the current centroids), then let
                # the next iteration re-assign around it
                cent[j] = x[_argbest(d.min(1), rank)]
    return assign, cent


def normalise_profiles(profiles: Sequence[dict]) -> np.ndarray:
    """profiles: dicts with bandwidth_mbps, latency_ms, jitter, straggle."""
    keys = ("bandwidth_mbps", "latency_ms", "jitter", "straggle")
    x = np.array([[float(p.get(k, 0.0)) for k in keys] for p in profiles])
    mu, sd = x.mean(0), x.std(0) + 1e-8
    return (x - mu) / sd


def reliability_weights(profiles: Sequence[dict],
                        assignments: Sequence[int]) -> List[float]:
    """omega_k (paper eq. 8): softmax over a reliability score =
    bandwidth / (latency * straggle), shared within a cluster."""
    import math
    scores = []
    for p in profiles:
        bw = float(p.get("bandwidth_mbps", 1.0))
        lat = float(p.get("latency_ms", 1.0))
        st = float(p.get("straggle", 1.0))
        scores.append(math.log(max(bw, 1e-3))
                      - 0.1 * math.log(max(lat, 1e-3))
                      - math.log(max(st, 1e-3)))
    # cluster-average the scores (personalised-but-stable weights)
    by_cluster = {}
    for s, a in zip(scores, assignments):
        by_cluster.setdefault(a, []).append(s)
    cl_mean = {a: sum(v) / len(v) for a, v in by_cluster.items()}
    sc = np.array([cl_mean[a] for a in assignments])
    e = np.exp(sc - sc.max())
    w = e / e.sum()
    return w.tolist()
