"""Live device clustering with hysteresis — port of
``repro/hierarchy/cluster.py``, numpy on the host: the warm-started
k-means refresh (:meth:`ClusterState.update`), the mapping of device
reliability weights onto fleet slots (:meth:`ClusterState.fleet_slots`,
:meth:`ClusterState.fleet_omega`, pod-major ``c * n_edge + e`` on a
hierarchical fleet), the per-cluster policies and the bottleneck
cluster's bandwidth the hierarchical strategy budgets against, and the
snapshot a checkpoint carries.

The host loop refreshes a :class:`ClusterState` on each replan; the fleet
omega it returns is the per-member aggregation weight of eq. (8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.clustering import (kmeans, normalise_profiles,
                                         reliability_weights)
from repro_torch.core.scheduler import kept_fraction


@dataclasses.dataclass
class ClusterPolicy:
    """Per-cluster coordination policy from the current telemetry.

    ``omega`` is the cluster's total reliability mass (its share of the
    fleet softmax); ``kept_fraction`` is the compression the scheduler
    would pick for the cluster's mean bandwidth (eq. 5), filled in when
    :meth:`ClusterState.policies` is given a config."""
    cluster: int
    members: List[int]
    bandwidth_mbps: float
    latency_ms: float
    straggle: float
    omega: float
    kept_fraction: Optional[float] = None


class ClusterState:
    """Warm-started k-means over telemetry with assignment hysteresis.

    Parameters
    ----------
    n_devices:
        Size of the simulated edge fleet (rows of each telemetry snapshot).
    k:
        Number of clusters.  When the mesh is hierarchical this should be
        the scheduler's ``n_cross`` so clusters map 1:1 onto cross-tier
        pods; on a flat mesh it is the config's ``n_clusters``.
    hysteresis:
        A device reassigns only if the squared distance to the proposed
        centroid is below ``(1 - hysteresis)`` times the distance to its
        current one.  0 disables the filter; 0.15 suppresses jitter-only
        flapping while still tracking genuine drift.
    """

    def __init__(self, n_devices: int, k: int, hysteresis: float = 0.15):
        self.n_devices = int(n_devices)
        self.k = max(1, min(int(k), self.n_devices))
        self.hysteresis = float(hysteresis)
        self.centroids: Optional[np.ndarray] = None
        self.assignments: Optional[List[int]] = None
        self.updates = 0      # update() calls
        self.churn = 0        # total device moves accepted past hysteresis
        self.reclusters = 0   # updates where at least one device moved

    # ------------------------------------------------------------------ #
    # clustering                                                         #
    # ------------------------------------------------------------------ #
    def update(self, telemetry: Sequence[Dict[str, float]]) -> bool:
        """Re-cluster on a fresh snapshot.  Returns True when assignments
        changed (first call always counts as a change)."""
        x = normalise_profiles(telemetry)
        init = self.centroids if (
            self.centroids is not None and len(self.centroids) == self.k
            and self.centroids.shape[1] == x.shape[1]) else None
        assign, cent = kmeans(x, self.k, init=init)
        self.updates += 1
        if self.assignments is None or len(self.assignments) != len(assign):
            self.assignments = [int(a) for a in assign]
            self.centroids = cent
            return True

        d = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        keep = 1.0 - self.hysteresis
        out = list(self.assignments)
        moved = 0
        for i, a in enumerate(assign):
            prev = out[i]
            a = int(a)
            if a != prev and d[i, a] < keep * d[i, prev]:
                out[i] = a
                moved += 1
        # Re-center on the post-hysteresis assignment so the next warm
        # start tracks the clustering the fleet actually runs with.
        for j in range(self.k):
            members = [i for i, a in enumerate(out) if a == j]
            if members:
                cent[j] = x[members].mean(axis=0)
        self.assignments = out
        self.centroids = cent
        if moved:
            self.churn += moved
            self.reclusters += 1
            return True
        return False

    # ------------------------------------------------------------------ #
    # host state a checkpoint carries                                    #
    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """JSON-able mutable state: warm-start centroids, the hysteresis
        anchor (current assignments) and the churn counters."""
        return {
            "centroids": (None if self.centroids is None
                          else [[float(v) for v in row]
                                for row in self.centroids]),
            "assignments": (None if self.assignments is None
                            else list(self.assignments)),
            "updates": self.updates,
            "churn": self.churn,
            "reclusters": self.reclusters,
        }

    def restore_snapshot(self, snap: dict):
        cent = snap.get("centroids")
        self.centroids = (None if cent is None
                          else np.asarray(cent, dtype=np.float64))
        assign = snap.get("assignments")
        self.assignments = None if assign is None else [int(a)
                                                        for a in assign]
        self.updates = int(snap.get("updates", 0))
        self.churn = int(snap.get("churn", 0))
        self.reclusters = int(snap.get("reclusters", 0))

    def _require_assignments(self) -> List[int]:
        if self.assignments is None:
            raise RuntimeError("ClusterState.update() has not been called")
        return self.assignments

    # ------------------------------------------------------------------ #
    # fleet mapping                                                      #
    # ------------------------------------------------------------------ #
    def fleet_slots(self, n_cross: int, n_edge: int) -> List[int]:
        """Map each device to a fleet slot (pod-major: ``pod*n_edge + e``).

        Clusters land on cross-tier pods by cluster id modulo ``n_cross``;
        within a pod, a cluster's devices round-robin over the edge slots.
        With more devices than slots several devices share a slot (their
        reliability mass is summed in :meth:`fleet_omega`)."""
        n_cross = max(int(n_cross), 1)
        n_edge = max(int(n_edge), 1)
        counters: Dict[int, int] = {}
        slots = []
        for a in self._require_assignments():
            pod = a % n_cross
            r = counters.get(pod, 0)
            counters[pod] = r + 1
            slots.append(pod * n_edge + (r % n_edge))
        return slots

    def fleet_omega(self, telemetry: Sequence[Dict[str, float]],
                    n_cross: int, n_edge: int = 1) -> Tuple[float, ...]:
        """Reliability weights omega, one per fleet member, normalised.

        Device-level softmax weights are summed into their fleet slots.
        Slots no device mapped to (fleet wider than the simulated edge
        set) are filled with their pod's mean weight — global mean when a
        whole pod is empty — so no fleet member's contribution is zeroed
        by an accident of the slot mapping."""
        n_cross = max(int(n_cross), 1)
        n_edge = max(int(n_edge), 1)
        w = reliability_weights(telemetry, self._require_assignments())
        om = np.zeros(n_cross * n_edge, dtype=np.float64)
        for s, wi in zip(self.fleet_slots(n_cross, n_edge), w):
            om[s] += float(wi)
        if (om <= 0.0).any():
            grid = om.reshape(n_cross, n_edge)
            pos = om[om > 0.0]
            global_fill = float(pos.mean()) if pos.size else 1.0
            for c in range(n_cross):
                row = grid[c]
                rpos = row[row > 0.0]
                fill = float(rpos.mean()) if rpos.size else global_fill
                row[row <= 0.0] = fill
            om = grid.reshape(-1)
        om = om / om.sum()
        return tuple(float(v) for v in om)

    # ------------------------------------------------------------------ #
    # per-cluster policies                                               #
    # ------------------------------------------------------------------ #
    def policies(self, telemetry: Sequence[Dict[str, float]],
                 cfg=None) -> List[ClusterPolicy]:
        """Per-cluster policies for the current assignment; with ``cfg``
        (an ACESyncConfig) each carries the eq-(5) kept fraction of the
        cluster's mean bandwidth."""
        assign = self._require_assignments()
        w = reliability_weights(telemetry, assign)
        out = []
        for j in range(self.k):
            members = [i for i, a in enumerate(assign) if a == j]
            if not members:
                continue
            bw = float(np.mean([telemetry[i]["bandwidth_mbps"]
                                for i in members]))
            out.append(ClusterPolicy(
                cluster=j,
                members=members,
                bandwidth_mbps=bw,
                latency_ms=float(np.mean([telemetry[i]["latency_ms"]
                                          for i in members])),
                straggle=float(np.mean([telemetry[i].get("straggle", 1.0)
                                        for i in members])),
                omega=float(sum(float(w[i]) for i in members)),
                kept_fraction=(None if cfg is None
                               else kept_fraction(cfg, bw))))
        return out

    def bottleneck_bandwidth(self, telemetry: Sequence[Dict[str, float]],
                             default: float = 50.0) -> float:
        """The slowest cluster's mean bandwidth (Mbps): the cross-tier
        exchange moves at the pace of its weakest cluster, so the
        hierarchical strategy budgets against it."""
        pols = self.policies(telemetry)
        if not pols:
            return default
        return min(p.bandwidth_mbps for p in pols)
