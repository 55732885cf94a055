"""End-to-end training driver: the host-side ACE-Sync control loop — port
of ``repro/launch/train.py``, one process per pod.

  telemetry -> clustering -> omega weights (eq 8)
  telemetry -> eq (5) budget -> importance scores -> knapsack -> SyncPlan
  divergence (eq 9) -> sync-interval H adaptation
  H local steps + 1 ACE-Sync round per window

The loop does not block on the card:

  * the step counter is mirrored on the host;
  * after the first (host-built) plan, a replan launches ONE device
    computation (importance scoring + the tensor knapsack,
    ``core/acesync.device_replan_fn``) and copies only the ``int32[G]``
    assignment to pinned host memory, asynchronously; the loop keeps
    stepping on the current plan and swaps once the copy has landed;
  * per-step metrics and the divergence EMA are read one step late.

With more than one pod the pods must switch plans on the same step (their
coalesced wires must have one layout), so replans and the eq-(9) interval
are applied synchronously at the step that launches them — the
reference's ``blocking_replans`` mode.  The inputs agree across pods: the
importance state is fed pod-mean grad stats, the divergence EMA is a pod
mean, and every pod reads the same seeded telemetry.

Omega comes from the live device clustering (:class:`~repro_torch.
hierarchy.ClusterState`): reliability weights summed into one slot per
fleet member.  On a hierarchical fleet (C clusters x E members) the
clustering keeps one cluster per cross-tier slot (k = C), the slots are
pod-major (``c * E + e``), and the clustering is handed to the strategy
(``acesync_hier`` budgets against its bottleneck cluster).

Surviving the fleet, as the reference does:

  * checkpoints every ``RunConfig.ckpt_every`` steps to ``ckpt_dir``
    (:class:`~repro_torch.checkpoint.checkpointer.Checkpointer`, the
    reference's on-disk format) carry the whole train state and, in the
    manifest extras, the plan, the scheduler's sync interval, the
    clustering, the loop counters and the pipeline position;
    :meth:`TrainLoop.restore_or_init` resumes from the newest one that
    verifies, and with ``blocking_replans`` a restart replays the
    uninterrupted run bit for bit — on the card only with
    ``RunConfig.deterministic`` (the CLI's ``--deterministic``), which
    :class:`~repro_torch.launch.session.TrainSession` applies before the
    model is built: ``torch.use_deterministic_algorithms(True)`` and
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, since attention's backward is
    not deterministic by default;
  * a seeded :class:`~repro_torch.runtime.faults.FaultSchedule` kills and
    rejoins pods, corrupts checkpoint leaves and delays heartbeats at
    fixed steps; every pod process holds the same schedule;
  * heartbeats: each pod records its step times, and the pods exchange
    them where the monitor is read — at each replan boundary (which
    blocks on P > 1 already), before a step's fault events and at the
    end of ``run_steps`` — in one small gather over the whole fleet,
    preempted pods included (its seconds in ``heartbeat_seconds``).
    Every pod then beats each live pod, step by step, with the first
    live pod's time, as the reference beats every pod with its one host
    time after each step — so every pod holds the same monitor, the
    straggle factors are uniform, and omega stays a function of the state
    trajectory.  With more than one pod the heartbeat timeouts are
    therefore checked at those points, not after every step;
  * elastic membership on a flat fleet: a killed pod's process stays
    alive and idle with its device state freed; the others continue as a
    fleet of P - 1 on the group of the alive pods (:meth:`PodGroup.
    regroup <repro_torch.launch.mesh.PodGroup.regroup>`), renumbered in
    pod order, with the batch re-balanced to the same rows per pod; at
    its rejoin the pod adopts the state of the new fleet's rank 0 (the
    reference's tile) and the loop's host state with it.  The transition
    is eager: it swaps at the event step, the reference's
    ``blocking_replans`` behaviour.

On a within-pod ("data", "model") mesh (the model's ``ctx``; one
process per rank) every rank runs this loop on the global batch (the
model keeps its block) with the same seeded inputs and replicated
metrics; replans apply at the step that launches them and the new plan's
levels are checked identical on every rank (``ShardCtx.check_replicated``).
Every rank checkpoints its shards into the reference's whole-leaf files
(the checkpointer over the mesh's world group, each leaf placed by
``Trainer.state_layout``): the files are those of the same state on one
card, so a restore reads its shards of any checkpoint of the model — one
written on another mesh shape, on one card, or by the reference — and
every rank takes the same host state from the manifest.  Rank 0 of the
mesh alone logs and injects checkpoint corruption.

Pods x ("data", "model") (``pods`` the group of the P ranks at this
rank's (d, m), ``launch.mesh.split_fleet_mesh``): the loop's host
exchanges — the step times, the heartbeats, the broadcasts of a
membership change — run over that group, and the exchanged step times
are then taken from the pod's mesh rank 0, so that every rank of the
fleet holds the same monitor.  At every plan refresh each rank checks
that H, the step, the plan's levels and omega are the same on every rank
of its pod.  Checkpoints hold row p of each leaf, each rank its shards
of it.  Elastic membership follows the reference's rule: data and model
stay fixed and only the pod axis changes; a preempted pod's D x M ranks
leave together, each (d, m)'s pod group regroups to the alive pods, and
a rejoining pod's rank (d, m) takes the state of pod 0's rank (d, m).

A two-tier fleet of meshes (``--pods C*E --edge E --data D --model M``:
C clusters x E members, each member a D x M mesh, ``pods`` the group of
the C * E members at this rank's (d, m) with its ``intra`` and ``cross``
sub-groups, ``launch.mesh.split_fleet_mesh(..., n_edge=E)``) runs the
same loop: the clustering keeps one cluster per cross-tier slot, as on a
hierarchical fleet of one-card members, and the plan-refresh check also
covers the plan's tier grid and the clustering's device assignment, so
that every rank of a member re-clusters alike and runs the same tier
groups' collectives.  Its membership is fixed, as the reference's.

CLI::

    python -m repro_torch.launch.train --steps 8 [--smoke] [--device cuda]
    python -m repro_torch.launch.train --data 2 --model 2 ...  # D*M ranks
    python -m repro_torch.launch.train --arch recurrentgemma-2b \
        --data 2 --model 2 ...               # every family: the recurrent,
    python -m repro_torch.launch.train --arch seamless-m4t-medium \
        --data 2 --model 2 ...               # the encoder-decoder, the VLM
    python -m repro_torch.launch.train --pods 2 --steps 8 ...  # P processes
    python -m repro_torch.launch.train --pods 2 --data 1 --model 2 \
        ...                                  # P*D*M ranks, pods x mesh
    python -m repro_torch.launch.train --pods 4 --edge 2 \
        --strategy acesync_hier ...          # 2 clusters x 2 members
    python -m repro_torch.launch.train --pods 4 --edge 2 --data 1 \
        --model 2 --strategy acesync_hier ...  # and each member a mesh
    ... --ckpt-dir DIR --ckpt-every N        # checkpoint; a rerun resumes
    ... --deterministic                      # and replays bit for bit
"""
from __future__ import annotations

import argparse
import gc
import inspect
import json
import math
import time
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import Checkpointer, MeshLayout
from repro_torch.configs.base import RunConfig, default_ckpt_dir
from repro_torch.core import acesync
from repro_torch.core.trainer import Trainer
from repro_torch.data.telemetry import make_profiles, snapshot
from repro_torch.hierarchy import ClusterState
from repro_torch.runtime import faults as F
from repro_torch.runtime.fault_tolerance import (ElasticPlanner,
                                                 HeartbeatMonitor, MeshPlan,
                                                 StragglerDetector)
from repro_torch.strategies import (STEP_ADVANCING, SYNC_KINDS, SyncStrategy,
                                    list_strategies)


class _HostFetch:
    """An asynchronous device -> host copy of a small tensor: the copy
    goes to pinned memory on the current stream, and an event says when it
    has landed."""

    def __init__(self, x: torch.Tensor):
        self._event = None
        if x.device.type == "cuda":
            self._host = torch.empty(x.shape, dtype=x.dtype,
                                     pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = x.detach().clone()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def get(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host


class TrainLoop:
    """Host control loop around the trainer's step kinds.

    ``pods`` is the fleet's pod group (None: one pod); a flat fleet
    changes its membership on a kill or a rejoin, a hierarchical one keeps
    its members; ``fault_schedule`` a :class:`~repro_torch.runtime.faults.
    FaultSchedule` (the same on every pod); ``blocking_replans`` applies
    replans and the eq-(9) interval at the step that launches them
    (always on with more than one pod)."""

    def __init__(self, model, run: RunConfig,
                 strategy: Union[str, SyncStrategy] = "acesync",
                 n_edge_devices: int = 8, seed: int = 0, pods=None,
                 fault_schedule: Optional[F.FaultSchedule] = None,
                 blocking_replans: bool = False):
        self.model = model
        self.run = run
        #: the ("data", "model") mesh the model is sharded over (None: one
        #: card)
        self.mesh = getattr(model, "ctx", None)
        self.trainer = Trainer(model, run, strategy=strategy, pods=pods)
        self.strategy = self.trainer.strategy
        #: the whole fleet's group, and the group of the current members
        #: (None while this pod is preempted)
        self.fleet = pods
        self.pods = pods
        self.ckpt = Checkpointer(
            run.ckpt_dir, pods=pods,
            mesh=None if self.mesh is None else MeshLayout(
                self.mesh.world, self.trainer.state_layout))
        self.profiles = make_profiles(n_edge_devices, seed)
        sched = self.trainer.scheduler
        # one cluster per cross-tier slot on a hierarchical fleet, the
        # config's n_clusters on a flat one
        self.clusters = ClusterState(
            n_edge_devices,
            sched.n_cross if sched.hier_enabled else run.acesync.n_clusters,
            hysteresis=run.acesync.cluster_hysteresis)
        self._plan_takes_clusters = "clusters" in inspect.signature(
            self.strategy.make_plan).parameters
        n = self.trainer.n_pods
        self.monitor = HeartbeatMonitor(n)
        self.straggler = StragglerDetector()
        # elastic membership only on a flat fleet (the edge dimension of a
        # hierarchical one is cluster topology, not membership)
        self.elastic = pods is not None and pods.n_edge == 1
        self.planner = (ElasticPlanner(MeshPlan(
            n_pods=n, data=1 if self.mesh is None else self.mesh.D,
            model=1 if self.mesh is None else self.mesh.M))
            if self.elastic else None)
        self.faults = fault_schedule
        #: apply replans and H at the step that launches them (all pods,
        #: and all ranks of a mesh, must switch plans on the same step; one
        #: pod: replays exactly)
        self.blocking_replans = (bool(blocking_replans) or n > 1
                                 or self.mesh is not None)
        self.history = []
        self.comm_bytes = 0.0
        self._plan = None
        self._steps_since_sync = 0
        self._H: Optional[int] = None
        self._host_step: Optional[int] = None
        self._pending_replan = None     # (fetch, omega)
        self._div_fetch: Optional[_HostFetch] = None
        self.device_replans = 0         # device replans applied
        self._pipeline = None           # the stream run_steps is draining
        # ---- elastic state ----
        #: the alive pods, and the members of the current group (the
        #: same on every process of the fleet, preempted ones included)
        self._members: List[int] = list(range(n))
        self._group_members = tuple(self._members)
        #: the trainer of each membership, by its group's global ranks
        self._trainers: Dict[tuple, Trainer] = {
            tuple(range(n)) if pods is None else tuple(pods.ranks):
            self.trainer}
        self._elastic_pending = None
        self._hb_delay: Dict[int, int] = {}
        self._hb_now: Optional[float] = None
        #: this pod's heartbeats not yet exchanged: per step, the pods
        #: to beat, its step time (None: preempted) and its clock
        self._hb_rows: List[tuple] = []
        #: this pod is preempted: its process idles, its state freed
        self.idle = False
        self._param_shapes = None
        #: membership transitions applied: the swap step, the step the
        #: event fired, the new pod count and members, and the seconds
        #: the swap took on this pod (the reference's
        #: ``served_from_warm_cache`` means nothing without a compile
        #: cache and is left out)
        self.membership_events: List[dict] = []
        #: every pod's step time (seconds) of each step, in fleet rank
        #: order (NaN: preempted); P > 1 only
        self.pod_step_times: List[List[float]] = []
        #: host seconds this pod spent in each heartbeat exchange
        #: (waiting for the other pods included); P > 1 only
        self.heartbeat_seconds: List[float] = []

    @property
    def plan(self):
        return self._plan

    def _lead(self) -> bool:
        """This process is rank 0 of its pod group and of its mesh."""
        return ((self.pods is None or self.pods.rank == 0)
                and (self.mesh is None or self.mesh.rank == 0))

    def _log(self, msg: str) -> None:
        if not self.idle and self._lead():
            print(msg, flush=True)

    # ---- policy refresh ---------------------------------------------------
    def _policy_inputs(self, step: int, sched=None):
        """Telemetry snapshot -> (telemetry, fleet omega): the straggle
        factors of the heartbeat monitor multiply into the telemetry's
        (device i reports through alive pod i mod P), the clustering is
        refreshed (warm-started k-means with hysteresis) and the device
        reliability weights are summed into one slot per fleet member of
        ``sched`` (default: the current trainer's)."""
        telem = snapshot(self.profiles, step)
        sf = self.straggler.straggle_factors(self.monitor)
        alive = sorted(sf) or [0]
        for i, t in enumerate(telem):
            t["straggle"] *= sf.get(alive[i % len(alive)], 1.0)
        self.clusters.update(telem)
        sched = sched or self.trainer.scheduler
        return telem, self.clusters.fleet_omega(telem, sched.n_cross,
                                                sched.n_edge)

    def refresh_plan(self, state, step: int):
        cfg = self.run.acesync
        telem, omega = self._policy_inputs(step)
        sched = self.trainer.scheduler
        dev_fn = (self.strategy.device_plan_fn(sched, cfg)
                  if state is not None else None)
        if dev_fn is not None and self._plan is not None:
            budget = sched.budget_for(
                self.strategy.budget_bandwidth(telem, self.clusters))
            ace = state["ace"]
            assign = dev_fn(ace.importance, ace.struct_feat, budget)
            self._pending_replan = (_HostFetch(assign), omega)
            return self._plan
        # host path: the first plan, and strategies without a device solver
        imp = None
        if self.strategy.uses_importance and state is not None:
            ace = state["ace"]
            with torch.no_grad():
                imp = acesync.scores_from(ace.importance, ace.struct_feat,
                                          cfg).cpu().tolist()
        kw = dict(importance=imp, telemetry=telem, omega=omega)
        if self._plan_takes_clusters:
            kw["clusters"] = self.clusters
        self._plan = self.strategy.make_plan(sched, **kw)
        return self._plan

    def _check_replicated(self, step: int) -> None:
        """On a mesh: H, the step, the plan's levels, tier grid and omega
        and the clustering's device assignment must be the same on every
        rank of the pod (a rank that diverged would run other collectives
        and hang the fleet)."""
        if self.mesh is None:
            return
        p = self._plan
        vals = [float(self._H or 0), float(step), *map(float, p.level_idx),
                *map(float, p.hier or ()), *map(float, p.omega),
                *map(float, self.clusters.assignments or ())]
        self.mesh.check_replicated(
            torch.tensor(vals, dtype=torch.float64, device=self.mesh.device),
            f"H, the step, the plan's levels, tier grid and omega and the "
            f"clusters at step {step}")

    def poll_replan(self, block: bool = False) -> bool:
        """Apply a pending device replan once its host copy has landed."""
        if self._pending_replan is None:
            return False
        fetch, omega = self._pending_replan
        if not block and not fetch.ready():
            return False
        got = fetch.get()
        if self.mesh is not None:
            self.mesh.check_replicated(got.to(self.mesh.device),
                                       "the replanned level assignments")
        idx = got.tolist()
        self._pending_replan = None
        self._plan = self.trainer.scheduler.plan_from_levels(
            idx, omega, adaptive=True)
        self.device_replans += 1
        return True

    def adapt_interval(self, state) -> int:
        """Eq-(9) sync-interval control on the divergence EMA read one
        replan late (the controller never waits on the step in flight);
        with ``blocking_replans``, read now."""
        if self.blocking_replans:
            return self.strategy.adapt(self.trainer.scheduler,
                                       float(state["ace"].div_ema))
        prev = self._div_fetch
        self._div_fetch = _HostFetch(state["ace"].div_ema)
        if prev is None:
            return (self.trainer.scheduler.sync_interval
                    if self.strategy.adapts_interval
                    else self.strategy.initial_interval(self.run.acesync))
        return self.strategy.adapt(self.trainer.scheduler,
                                   float(prev.get()))

    # ---- checkpoint state ---------------------------------------------------
    def _plan_snapshot(self) -> Optional[dict]:
        p = self._plan
        if p is None:
            return None
        return {"level_idx": list(p.level_idx),
                "omega": [float(w) for w in p.omega],
                "sync_interval": int(p.sync_interval),
                "adaptive": bool(p.adaptive)}

    def ckpt_extras(self) -> dict:
        """Everything outside the state a restart needs, JSON-able (it
        rides in the manifest): the pipeline position, the plan, the
        scheduler's sync interval, the clustering and the loop counters."""
        return {
            "pipeline": (self._pipeline.snapshot()
                         if self._pipeline is not None else None),
            "plan": self._plan_snapshot(),
            "scheduler": self.trainer.scheduler.snapshot(),
            "clusters": self.clusters.snapshot(),
            "loop": {"steps_since_sync": int(self._steps_since_sync),
                     "H": None if self._H is None else int(self._H),
                     "n_pods": int(self.trainer.n_pods),
                     "comm_bytes": float(self.comm_bytes)},
        }

    def _restore_extras(self, extras: dict, pipeline):
        if extras.get("pipeline") and pipeline is not None:
            pipeline.restore(extras["pipeline"])
        if extras.get("scheduler"):
            self.trainer.scheduler.restore_snapshot(extras["scheduler"])
        if extras.get("clusters"):
            self.clusters.restore_snapshot(extras["clusters"])
        lp = extras.get("loop") or {}
        self._steps_since_sync = int(lp.get("steps_since_sync", 0))
        h = lp.get("H")
        self._H = None if h is None else int(h)
        self.comm_bytes = float(lp.get("comm_bytes", 0.0))
        ps = extras.get("plan")
        if ps:
            # rebuilt through the scheduler, so that the bucket signature
            # and the chunk and segment grids derive as they did mid-run
            self._plan = self.trainer.scheduler.plan_from_levels(
                ps["level_idx"], omega=ps["omega"],
                sync_interval=ps.get("sync_interval"),
                adaptive=bool(ps.get("adaptive", False)))

    def restore_or_init(self, seed: int, pipeline):
        """The newest checkpoint in ``ckpt_dir`` that verifies (with its
        host state), else a fresh state from ``seed``."""
        if self.ckpt.latest_step() is None:
            return self.trainer.init_state(seed)
        state, extras = self.ckpt.restore(self.trainer.init_state(seed))
        self._restore_extras(extras, pipeline)
        self._log(f"restored checkpoint @ step {int(state['step'])}")
        return state

    # ---- fault injection & elastic membership -----------------------------
    def _apply_faults(self, step: int):
        if self.faults is None:
            return
        events = self.faults.due(step)
        if events:
            # the monitor as of the last step, before the events touch it
            self._exchange_heartbeats()
        for ev in events:
            if ev.kind == F.KILL_POD:
                self._on_pods_dead([ev.target])
            elif ev.kind == F.REJOIN_POD:
                self._on_pod_rejoin(ev.target)
            elif ev.kind == F.CORRUPT_CKPT:
                if self.idle:
                    continue
                self.ckpt.wait()
                if self._lead():
                    path = F.corrupt_checkpoint_leaf(
                        self.ckpt.dir, ev.target, seed=ev.step)
                    if path:
                        self._log(f"FAULT step {step}: corrupted {path}")
            elif ev.kind == F.DELAY_HEARTBEAT:
                self._hb_delay[ev.target] = max(
                    self._hb_delay.get(ev.target, 0), ev.duration)

    def _on_pods_dead(self, pods: Sequence[int]):
        for p in pods:
            self.monitor.mark_dead(p)
        if not self.elastic:
            return
        plan = self.planner.on_pod_failure(pods)
        self._members = [m for m in self._members if m not in set(pods)]
        self._log(f"ELASTIC: pods {sorted(pods)} dead -> fleet "
                  f"P={plan.n_pods}")
        self._begin_transition(plan.n_pods)

    def _on_pod_rejoin(self, pod: int):
        self.monitor.register(pod, now=self._hb_now)
        if not self.elastic:
            return
        plan = self.planner.on_pod_join(1)
        self._members = sorted(set(self._members) | {pod})
        self._log(f"ELASTIC: pod {pod} rejoined -> fleet P={plan.n_pods}")
        self._begin_transition(plan.n_pods)

    def _trainer_for(self, group) -> Trainer:
        """The trainer of a membership (cached per membership, as the
        reference caches one per pod count: a fleet that returns to a
        membership reuses its plans' device forms)."""
        key = tuple(group.ranks)
        tr = self._trainers.get(key)
        if tr is None:
            tr = Trainer(self.model, self.run, strategy=self.strategy,
                         pods=group)
            self._trainers[key] = tr
        return tr

    def _begin_transition(self, n_new: int):
        """Stage a membership change on every process of the fleet: the
        group of the new members (collective over the fleet, so a
        preempted pod's process takes part); on the members, the host
        state of a rejoining pod from the new rank 0, the membership's
        trainer with the sync interval carried over, a plan priced at
        the new fleet size, and the batch re-balanced to the same rows
        per pod.  :meth:`_poll_elastic` swaps it in."""
        members = tuple(self._members)
        if not self.elastic or members == self._group_members:
            return
        t0 = time.perf_counter()
        launched = self._host_step or 0
        before, self._group_members = self._group_members, members
        group = self.fleet.regroup([self.fleet.ranks[p] for p in members])
        if group is None:
            self._elastic_pending = (None, None, None, launched, t0, group,
                                     ())
            return
        joining = tuple(r for r, m in enumerate(members) if m not in before)
        if joining:
            # a rejoining pod takes the host state of the new rank 0
            extras = group.broadcast_object(
                self.ckpt_extras() if group.rank == 0 else None)
            if self.idle:
                self._alloc_params()
                self._restore_extras(extras, self._pipeline)
        old = self.trainer
        tr = self._trainer_for(group)
        tr.scheduler.restore_snapshot(old.scheduler.snapshot())
        # omega at the new fleet size (the reference prices it at the old
        # one, whose trainer is still current there: ROADMAP R6)
        telem, omega = self._policy_inputs(launched, sched=tr.scheduler)
        kw = dict(importance=None, telemetry=telem, omega=omega)
        if self._plan_takes_clusters:
            kw["clusters"] = self.clusters
        plan = self.strategy.make_plan(tr.scheduler, **kw)
        pipe = self._pipeline
        if pipe is not None:
            rows = self.planner.rebalanced_rows(pipe.shape.global_batch,
                                                old.n_pods)
            pipe = pipe.resized(rows, pod=group.rank, n_pods=group.size)
        self._elastic_pending = (tr, plan, pipe, launched, t0, group,
                                 joining)

    def _transfer_state(self, state, tr: Trainer, group, joining):
        """The state on the new fleet.  One process per pod, so each pod
        keeps its own rows: a preempted pod frees its state (the dead
        pod's EF residuals and moments leave with it), survivors keep
        theirs, and a rejoining pod receives the state of the new rank 0
        (the reference's tile gives the new pod row 0's).  The reference
        cuts the pod dimension to its first rows instead, whichever pod
        died (ROADMAP R5); both agree when the last pod dies."""
        if group is None:
            self._free_state(state)
            return None
        if self.idle:
            state = tr.init_state(self.run.seed)
        if joining:
            group.send_state([leaf for _, leaf in
                              T.reference_leaves_with_path(state)], 0,
                             joining)
        return state

    def _free_state(self, state):
        """A preempted pod: free the device state.  Every leaf goes down
        to empty storage (the session may still hold the tree), the
        model's parameters with their shapes kept for the rejoin."""
        self._pending_replan = None
        self._div_fetch = None
        self._param_shapes = [tuple(p.shape) for p in
                              T.leaves(self.model.param_tree())]
        with torch.no_grad():
            for _, leaf in T.reference_leaves_with_path(state):
                leaf.data = leaf.data.new_empty((0,))
        gc.collect()
        if self.model.device.type == "cuda":
            torch.cuda.empty_cache()
        self.idle = True

    def _alloc_params(self):
        with torch.no_grad():
            for p, shape in zip(T.leaves(self.model.param_tree()),
                                self._param_shapes):
                p.data = p.data.new_empty(shape)

    def _poll_elastic(self, state):
        """Apply a staged membership transition (the transition is eager:
        it lands at the step it was staged).  Returns the state on the
        new fleet (None on a preempted pod)."""
        if self._elastic_pending is None:
            return state
        tr, plan, pipe, launched, t0, group, joining = self._elastic_pending
        self._elastic_pending = None
        state = self._transfer_state(state, tr, group, joining)
        self.pods = group
        if group is None:
            return None
        self.idle = False
        # a pending replan was priced for the old fleet: the next refresh
        # replans at the new size
        self._pending_replan = None
        self.trainer = tr
        self.ckpt.pods = group
        if pipe is not None:
            self._pipeline = pipe
        self._plan = plan
        self.membership_events.append({
            "step": self._host_step, "launched_step": launched,
            "n_pods": group.size, "warm_steps": (self._host_step or 0)
            - launched, "members": list(self._group_members),
            "seconds": time.perf_counter() - t0})
        self._log(f"ELASTIC: swapped to P={group.size} (pods "
                  f"{list(self._group_members)}) at step {self._host_step}")
        return state

    def _beat_pods(self) -> List[int]:
        out = []
        for pod in self.monitor.alive_pods():
            d = self._hb_delay.get(pod, 0)
            if d > 0:
                self._hb_delay[pod] = d - 1
                continue
            out.append(pod)
        return out

    def _heartbeat(self, dt: Optional[float]):
        """One pod: beat the live pods with this step's time and mark the
        silent ones dead.  More pods: record the step's beat for the next
        :meth:`_exchange_heartbeats`."""
        now = time.time()
        if self.fleet is None:
            self._beat(self._beat_pods(), dt, now)
        else:
            self._hb_rows.append((self._beat_pods(), dt, now))

    def _beat(self, pods: Sequence[int], dt: float, now: float):
        self._hb_now = now
        for pod in pods:
            self.monitor.beat(pod, dt, now=now)
        newly_dead = self.monitor.check(now=now)
        if newly_dead:
            self._on_pods_dead(newly_dead)

    def _exchange_heartbeats(self):
        """Exchange the recorded steps' times over the fleet (NaN: a
        preempted pod) and apply each step's beats in order, with the
        first live pod's time and clock, so that every process holds the
        same monitor.  Every process of the fleet calls it at the same
        steps."""
        rows, self._hb_rows = self._hb_rows, []
        if not rows:
            return
        t0 = time.perf_counter()
        got = self.fleet.gather_floats(
            [x for _, dt, now in rows
             for x in (math.nan if dt is None else dt, now)])
        if self.mesh is not None and self.mesh.world is not None:
            # the pod's mesh rank 0's exchange (the ranks at its (d, m) on
            # every pod got the same): one monitor on every rank
            got = self.mesh.world.broadcast_object(got)
        self.heartbeat_seconds.append(time.perf_counter() - t0)
        for j, (pods, _, _) in enumerate(rows):
            times = [(g[2 * j], g[2 * j + 1]) for g in got]
            self.pod_step_times.append([t for t, _ in times])
            dt, now = next(x for x in times if not math.isnan(x[0]))
            # a pod a timeout marked dead at an earlier step of the batch
            # is beaten no more (a beat would register it again)
            alive = set(self.monitor.alive_pods())
            self._beat([p for p in pods if p in alive], dt, now)

    # ---- main loop ----------------------------------------------------------
    def _flush_metrics(self, inflight, log_every):
        fetches, rec, idx = inflight
        rec.update({k: float(f.get()) for k, f in fetches.items()})
        self.history.append(rec)
        if log_every and idx % log_every == 0:
            self._log(f"step {rec['step']:5d} "
                      f"loss={rec.get('loss', float('nan')):.4f} "
                      f"H={rec['H']} dt={rec['dt']:.2f}s")

    def run_steps(self, state, pipeline, n_steps: int, log_every: int = 10):
        """Run ``n_steps`` steps (a preempted pod idles through them in
        step with the fleet) and return the state (None on a pod that is
        preempted at the end)."""
        run = self.run
        cfg = run.acesync
        self._pipeline = pipeline
        if state is not None:
            # one synchronous read to seed the host step mirror
            self._host_step = int(state["step"])
        if self._plan is None and not self.idle:
            self.refresh_plan(state, self._host_step)
            if self.blocking_replans:
                self.poll_replan(block=True)
            self._check_replicated(self._host_step)
        inflight = None
        for i in range(n_steps):
            step = self._host_step
            if step and step % cfg.replan_every == 0:
                self._exchange_heartbeats()
            self._apply_faults(step)
            state = self._poll_elastic(state)
            if self.idle:
                # one step kind per iteration advances the step counter
                self._host_step += 1
                self._heartbeat(None)
                continue
            self.poll_replan()
            if step and step % cfg.replan_every == 0:
                self.refresh_plan(state, step)
                if self.blocking_replans:
                    self.poll_replan(block=True)
                self._H = self.adapt_interval(state)
                self._check_replicated(step)
            H = (self._H if self._H is not None
                 else self.strategy.initial_interval(cfg))
            batch = next(self._pipeline)
            t0 = time.perf_counter()
            kinds = self.strategy.step_schedule(self._steps_since_sync, H)
            metrics = {}
            for kind in kinds:
                state, m = self.trainer.step(state, batch, self._plan, kind)
                metrics.update(m)
                self.comm_bytes += self.strategy.wire_bytes(
                    self.trainer.scheduler, self._plan, kind)
                if kind in STEP_ADVANCING:
                    self._host_step += 1
            if SYNC_KINDS & set(kinds):
                self._steps_since_sync = 0
            else:
                self._steps_since_sync += 1
            fetches = {k: _HostFetch(v) for k, v in metrics.items()}
            if inflight is not None:
                self._flush_metrics(inflight, log_every)
            dt = time.perf_counter() - t0
            self._heartbeat(dt)
            inflight = (fetches, dict(step=step, dt=dt, H=H,
                                      kinds=list(kinds)), i)
            done = self._host_step  # the state holds the post-step counter
            if run.ckpt_every and done % run.ckpt_every == 0:
                self.ckpt.save(done, state, extras=self.ckpt_extras())
        if inflight is not None:
            self._flush_metrics(inflight, log_every)
        self._exchange_heartbeats()
        return state


def _session_kwargs(args) -> dict:
    kw = dict(strategy=args.strategy, smoke=args.smoke,
              seq_len=args.seq_len, batch=args.batch, steps=args.steps,
              warmup_steps=10, ckpt_dir=args.ckpt_dir,
              deterministic=args.deterministic)
    if args.ckpt_every is not None:
        kw["ckpt_every"] = args.ckpt_every
    return kw


def _summary(sess) -> dict:
    losses = sess.losses
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "steps": len(losses), "comm_bytes": sess.comm_bytes,
            "start_step": sess.history[0]["step"],
            "device": str(sess.model.device)}


def _pod_run(group, arch, kw, steps):
    """One pod's CLI run (spawned by ``--pods``): its summary, the payload
    bytes it received over the cross tier (the fleet's gathers and rings
    and the cross sub-group's) and within its cluster."""
    from repro_torch.launch.session import TrainSession
    sess = TrainSession.from_config(arch, pods=group, **kw)
    sess.run(steps, log_every=10 if group.rank == 0 else 0)
    sess.finish()
    payload = ("gather", "ring")
    return dict(_summary(sess), pod=group.rank,
                wire_bytes=group.bytes_logged(payload, ("fleet", "cross")),
                intra_bytes=group.bytes_logged(payload, "intra"))


def _mesh_run(ctx, pods, arch, kw, steps):
    """One rank's CLI run on a ("data", "model") mesh (spawned by
    ``--data`` / ``--model``; with ``pods``, the pods at its (d, m) on a
    fleet of meshes, ``--pods`` too): its summary; rank 0 logs.  On a
    fleet its pod, cluster and member, the payload bytes its (d, m)'s
    cross tier received (the pod group's and the ``cross`` sub-group's)
    and its ``intra`` sub-group's."""
    from repro_torch.launch.session import TrainSession
    sess = TrainSession.from_config(arch, mesh=ctx, pods=pods, **kw)
    lead = ctx.rank == 0 and (pods is None or pods.rank == 0)
    sess.run(steps, log_every=10 if lead else 0)
    sess.finish()
    out = dict(_summary(sess), rank=ctx.rank)
    if pods is not None:
        payload = ("gather", "ring", "full")
        out.update(pod=pods.rank, cluster=pods.rank // pods.n_edge,
                   member=pods.rank % pods.n_edge,
                   wire_bytes=pods.bytes_logged(payload, ("pod", "cross")),
                   intra_bytes=pods.bytes_logged(payload, "intra"))
    return out


def main(argv=None):
    from repro_torch.launch.session import TrainSession

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-350m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--strategy", default="acesync",
                    choices=list_strategies())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split over the pods)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods (fleet members), one process each")
    ap.add_argument("--edge", type=int, default=1,
                    help="members per cluster: --pods P --edge E runs a "
                         "two-tier fleet of P/E clusters")
    ap.add_argument("--data", type=int, default=1,
                    help="ranks of the within-pod mesh's 'data' axis "
                         "(FSDP, batch blocks)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks of its 'model' axis (tensor and expert "
                         "parallelism); --data D --model M runs D*M "
                         "processes, rank 0 printing the JSON")
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir(),
                    help="checkpoint directory (default: repro_ckpt in "
                         "$TMPDIR or /tmp); a run resumes from the newest "
                         "checkpoint there that verifies")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint cadence in steps (default: RunConfig)")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic algorithms on the card, so that a "
                         "resumed run replays the uninterrupted one bit "
                         "for bit")
    args = ap.parse_args(argv)
    if args.pods % args.edge:
        ap.error(f"--pods {args.pods} does not split into clusters of "
                 f"--edge {args.edge}")

    kw = _session_kwargs(args)
    if args.data * args.model > 1:
        if args.pods > 1:
            from repro_torch.launch.mesh import spawn_fleet_mesh
            outs = spawn_fleet_mesh(_mesh_run, args.pods, args.data,
                                    args.model, args.device,
                                    args=(args.arch, kw, args.steps),
                                    n_edge=args.edge)
            print(json.dumps(dict(outs[0], pods=args.pods, edge=args.edge,
                                  data=args.data, model=args.model,
                                  ranks=[{k: o[k] for k in
                                          ("pod", "cluster", "member",
                                           "rank", "wire_bytes",
                                           "intra_bytes", "last_loss")}
                                         for o in outs])))
            return
        from repro_torch.launch.mesh import spawn_mesh
        outs = spawn_mesh(_mesh_run, args.data, args.model, args.device,
                          args=(None, args.arch, kw, args.steps))
        print(json.dumps(dict(outs[0], data=args.data, model=args.model)))
        return
    if args.pods > 1:
        from repro_torch.launch.mesh import spawn_pods
        outs = spawn_pods(_pod_run, args.pods, args.device,
                          args=(args.arch, kw, args.steps),
                          n_edge=args.edge)
        print(json.dumps(dict(outs[0], pods=outs)))
        return
    sess = TrainSession.from_config(args.arch, device=args.device, **kw)
    sess.run(args.steps)
    sess.finish()
    print(json.dumps(_summary(sess)))


if __name__ == "__main__":
    main()
