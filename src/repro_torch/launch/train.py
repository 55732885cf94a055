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
Checkpointing, fault injection and elastic membership come with later
slices of the port.

CLI::

    python -m repro_torch.launch.train --steps 8 [--smoke] [--device cuda]
    python -m repro_torch.launch.train --pods 2 --steps 8 ...  # P processes
    python -m repro_torch.launch.train --pods 4 --edge 2 \
        --strategy acesync_hier ...          # 2 clusters x 2 members
"""
from __future__ import annotations

import argparse
import inspect
import json
import time
from typing import Optional, Union

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import acesync
from repro_torch.core.trainer import Trainer
from repro_torch.data.telemetry import make_profiles, snapshot
from repro_torch.hierarchy import ClusterState
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
    """Host control loop around the trainer's step kinds."""

    def __init__(self, model, run: RunConfig,
                 strategy: Union[str, SyncStrategy] = "acesync",
                 n_edge_devices: int = 8, seed: int = 0, pods=None):
        self.model = model
        self.run = run
        self.trainer = Trainer(model, run, strategy=strategy, pods=pods)
        self.strategy = self.trainer.strategy
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
        #: apply replans and H at the step that launches them (all pods
        #: must switch plans on the same step)
        self.blocking_replans = self.trainer.n_pods > 1
        self.history = []
        self.comm_bytes = 0.0
        self._plan = None
        self._steps_since_sync = 0
        self._H: Optional[int] = None
        self._host_step: Optional[int] = None
        self._pending_replan = None     # (fetch, omega)
        self._div_fetch: Optional[_HostFetch] = None
        self.device_replans = 0         # device replans applied

    @property
    def plan(self):
        return self._plan

    # ---- policy refresh ---------------------------------------------------
    def _policy_inputs(self, step: int):
        """Telemetry snapshot -> (telemetry, fleet omega): the clustering
        is refreshed (warm-started k-means with hysteresis) and the device
        reliability weights are summed into one slot per fleet member."""
        telem = snapshot(self.profiles, step)
        self.clusters.update(telem)
        sched = self.trainer.scheduler
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

    def poll_replan(self, block: bool = False) -> bool:
        """Apply a pending device replan once its host copy has landed."""
        if self._pending_replan is None:
            return False
        fetch, omega = self._pending_replan
        if not block and not fetch.ready():
            return False
        idx = fetch.get().tolist()
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

    # ---- main loop ----------------------------------------------------------
    def _flush_metrics(self, inflight, log_every):
        fetches, rec, idx = inflight
        rec.update({k: float(f.get()) for k, f in fetches.items()})
        self.history.append(rec)
        if log_every and idx % log_every == 0:
            print(f"step {rec['step']:5d} "
                  f"loss={rec.get('loss', float('nan')):.4f} "
                  f"H={rec['H']} dt={rec['dt']:.2f}s", flush=True)

    def run_steps(self, state, pipeline, n_steps: int, log_every: int = 10):
        cfg = self.run.acesync
        H = (self._H if self._H is not None
             else self.strategy.initial_interval(cfg))
        # one synchronous read to seed the host step mirror
        self._host_step = int(state["step"])
        if self._plan is None:
            self.refresh_plan(state, self._host_step)
        inflight = None
        for i in range(n_steps):
            step = self._host_step
            self.poll_replan()
            if step and step % cfg.replan_every == 0:
                self.refresh_plan(state, step)
                if self.blocking_replans:
                    self.poll_replan(block=True)
                H = self.adapt_interval(state)
                self._H = H
            batch = next(pipeline)
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
            inflight = (fetches, dict(step=step, dt=dt, H=H,
                                      kinds=list(kinds)), i)
        if inflight is not None:
            self._flush_metrics(inflight, log_every)
        return state


def _session_kwargs(args) -> dict:
    return dict(strategy=args.strategy, smoke=args.smoke,
                seq_len=args.seq_len, batch=args.batch, steps=args.steps,
                warmup_steps=10)


def _summary(sess) -> dict:
    losses = sess.losses
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "steps": len(losses), "comm_bytes": sess.comm_bytes,
            "device": str(sess.model.device)}


def _pod_run(group, arch, kw, steps):
    """One pod's CLI run (spawned by ``--pods``): its summary, the payload
    bytes it received over the cross tier (the fleet's gathers and rings
    and the cross sub-group's) and within its cluster."""
    from repro_torch.launch.session import TrainSession
    sess = TrainSession.from_config(arch, pods=group, **kw)
    sess.run(steps, log_every=10 if group.rank == 0 else 0)
    payload = ("gather", "ring")
    return dict(_summary(sess), pod=group.rank,
                wire_bytes=group.bytes_logged(payload, ("fleet", "cross")),
                intra_bytes=group.bytes_logged(payload, "intra"))


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
    args = ap.parse_args(argv)
    if args.pods % args.edge:
        ap.error(f"--pods {args.pods} does not split into clusters of "
                 f"--edge {args.edge}")

    kw = _session_kwargs(args)
    if args.pods > 1:
        from repro_torch.launch.mesh import spawn_pods
        outs = spawn_pods(_pod_run, args.pods, args.device,
                          args=(args.arch, kw, args.steps),
                          n_edge=args.edge)
        print(json.dumps(dict(outs[0], pods=outs)))
        return
    sess = TrainSession.from_config(args.arch, device=args.device, **kw)
    sess.run(args.steps)
    print(json.dumps(_summary(sess)))


if __name__ == "__main__":
    main()
