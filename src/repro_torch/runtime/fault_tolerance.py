"""Fault tolerance & elasticity runtime — a copy of
``repro/runtime/fault_tolerance.py`` (numpy only): the same decisions on
the same inputs.

On a real multi-pod deployment these hooks wire into the cluster manager;
here every decision path is implemented and unit-tested against simulated
telemetry, and the launcher (launch/train.py) consumes them:

  * HeartbeatMonitor  — per-pod liveness from step-completion timestamps;
    marks a pod dead after ``timeout_s`` silence, and carries an explicit
    register/rejoin path so a preempted pod coming back (or a pod id the
    monitor has never seen) re-enters cleanly instead of KeyError-ing.
  * StragglerDetector — robust (median + MAD) step-time outlier detection;
    feeds the reliability weights omega (paper eq. 8) so persistent
    stragglers are down-weighted instead of stalling the ring.
  * ElasticPlanner    — maps a membership event (failure OR rejoin) to a
    new mesh plan: drop/re-add the pod, re-balance the batch; the
    launcher re-derives ring hops and re-keys the compiled step through
    the bucket-signature path (checkpointer re-shards pod-dim leaves).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PodStatus:
    pod_id: int
    last_seen: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_pods: int, timeout_s: float = 300.0):
        now = time.time()
        self.timeout_s = timeout_s
        self.pods = {i: PodStatus(i, now) for i in range(n_pods)}

    def register(self, pod_id: int, now: Optional[float] = None):
        """Explicit (re)join: a brand-new pod id gets a status record; a
        known-dead pod is resurrected with its stale step times cleared —
        pre-preemption timings would poison the straggler stats of the
        restarted pod (fresh host, cold caches, different neighbours)."""
        now = now if now is not None else time.time()
        st = self.pods.get(pod_id)
        if st is None:
            self.pods[pod_id] = PodStatus(pod_id, now)
            return
        if not st.alive:
            st.alive = True
            st.step_times = []
        st.last_seen = now

    def drop(self, pod_id: int):
        """Forget a pod entirely (it left the fleet for good)."""
        self.pods.pop(pod_id, None)

    def mark_dead(self, pod_id: int):
        """Force-mark a pod dead (fault injection / external signal)."""
        st = self.pods.get(pod_id)
        if st is not None:
            st.alive = False

    def beat(self, pod_id: int, step_time_s: float,
             now: Optional[float] = None):
        """Record a step completion.  Unknown or previously-dead pods are
        routed through :meth:`register` first — a rejoined pod's beat must
        never raise, and must not resurrect stale timing state."""
        st = self.pods.get(pod_id)
        if st is None or not st.alive:
            self.register(pod_id, now)
            st = self.pods[pod_id]
        st.last_seen = now if now is not None else time.time()
        st.step_times.append(step_time_s)
        if len(st.step_times) > 256:
            st.step_times = st.step_times[-128:]

    def check(self, now: Optional[float] = None) -> List[int]:
        """-> list of pods newly marked dead."""
        now = now if now is not None else time.time()
        dead = []
        for st in self.pods.values():
            if st.alive and now - st.last_seen > self.timeout_s:
                st.alive = False
                dead.append(st.pod_id)
        return dead

    def alive_pods(self) -> List[int]:
        return [i for i, st in self.pods.items() if st.alive]


class StragglerDetector:
    """Median/MAD outlier detection over recent step times.

    ``mad_floor_frac`` guards the near-zero-MAD regime: when every pod
    steps in statistically identical time the raw MAD collapses toward 0
    and any ulp of jitter would divide into a huge z-score, spuriously
    flagging healthy pods.  The deviation scale is floored at this
    fraction of the median step time, so only pods slower by a meaningful
    margin can be flagged at all.
    """

    def __init__(self, threshold: float = 3.0,
                 mad_floor_frac: float = 0.01):
        self.threshold = threshold
        self.mad_floor_frac = mad_floor_frac

    def straggle_factors(self, monitor: HeartbeatMonitor) -> Dict[int, float]:
        pods = monitor.alive_pods()
        med_times = {}
        for i in pods:
            ts = monitor.pods[i].step_times[-32:]
            med_times[i] = float(np.median(ts)) if ts else 0.0
        vals = np.array([v for v in med_times.values() if v > 0])
        if len(vals) == 0:
            return {i: 1.0 for i in pods}
        med = float(np.median(vals))
        return {i: (med_times[i] / med if med > 0 and med_times[i] > 0
                    else 1.0) for i in pods}

    def stragglers(self, monitor: HeartbeatMonitor) -> List[int]:
        f = self.straggle_factors(monitor)
        if not f:
            return []
        vals = np.array(list(f.values()))
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med)))
        scale = max(mad, self.mad_floor_frac * max(med, 1e-12), 1e-12)
        return [i for i, v in f.items()
                if (v - med) / scale > self.threshold]


@dataclasses.dataclass
class MeshPlan:
    n_pods: int
    data: int
    model: int

    @property
    def shape(self):
        if self.n_pods > 1:
            return (self.n_pods, self.data, self.model)
        return (self.data, self.model)

    @property
    def axis_names(self):
        if self.n_pods > 1:
            return ("pod", "data", "model")
        return ("data", "model")


class ElasticPlanner:
    """Membership event -> new mesh plan + restart decision."""

    def __init__(self, initial: MeshPlan):
        self.plan = initial
        self.max_pods = initial.n_pods

    def on_pod_failure(self, dead_pods: Sequence[int]) -> MeshPlan:
        remaining = self.plan.n_pods - len(set(dead_pods))
        if remaining < 1:
            raise RuntimeError("all pods dead")
        self.plan = MeshPlan(n_pods=remaining, data=self.plan.data,
                             model=self.plan.model)
        return self.plan

    def on_pod_join(self, n_joining: int = 1) -> MeshPlan:
        """A preempted pod rejoined (or capacity was added): grow the pod
        axis again, capped at the largest fleet this planner has seen —
        the device inventory the launcher actually holds."""
        grown = min(self.plan.n_pods + int(n_joining), self.max_pods)
        self.plan = MeshPlan(n_pods=grown, data=self.plan.data,
                             model=self.plan.model)
        return self.plan

    def rebalanced_batch(self, global_batch: int) -> int:
        """Keep per-chip batch constant: shrink the global batch with the
        pod count (deterministic grad-noise scale is preserved by LR scale
        on the host side)."""
        chips = self.plan.n_pods * self.plan.data * self.plan.model
        per = max(1, global_batch // max(chips, 1))
        return per * chips

    def rebalanced_rows(self, global_rows: int, old_n_pods: int) -> int:
        """Re-balance the batch ROW count across a pod-count change,
        keeping rows-per-pod constant (batch rows shard over the pod and
        data axes; the model axis replicates them)."""
        slices_old = max(old_n_pods * self.plan.data, 1)
        per = max(1, global_rows // slices_old)
        return per * self.plan.n_pods * self.plan.data
