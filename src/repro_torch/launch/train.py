"""End-to-end training driver: the host-side ACE-Sync control loop — port
of ``repro/launch/train.py`` for one pod.

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

Omega is ``(1.0,)``: the reference's cluster controller gives one fleet
slot its whole weight.  Checkpointing, fault injection, elastic membership
and clustering come with later slices of the port.

CLI::

    python -m repro_torch.launch.train --steps 8 [--smoke] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Union

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import acesync
from repro_torch.core.trainer import Trainer
from repro_torch.data.telemetry import make_profiles, snapshot
from repro_torch.strategies import (STEP_ADVANCING, SYNC_KINDS, SyncStrategy,
                                    list_strategies)

#: one pod holds the whole fleet weight
ONE_POD_OMEGA = (1.0,)


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
                 n_edge_devices: int = 8, seed: int = 0):
        self.model = model
        self.run = run
        self.trainer = Trainer(model, run, strategy=strategy)
        self.strategy = self.trainer.strategy
        self.profiles = make_profiles(n_edge_devices, seed)
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
        """Telemetry snapshot and the fleet omega of one pod."""
        return snapshot(self.profiles, step), ONE_POD_OMEGA

    def refresh_plan(self, state, step: int):
        cfg = self.run.acesync
        telem, omega = self._policy_inputs(step)
        sched = self.trainer.scheduler
        dev_fn = (self.strategy.device_plan_fn(sched, cfg)
                  if state is not None else None)
        if dev_fn is not None and self._plan is not None:
            budget = sched.budget_for(self.strategy.budget_bandwidth(telem))
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
        self._plan = self.strategy.make_plan(sched, importance=imp,
                                             telemetry=telem, omega=omega)
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
        replan late (the controller never waits on the step in flight)."""
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sess = TrainSession.from_config(
        args.arch, strategy=args.strategy, smoke=args.smoke,
        seq_len=args.seq_len, batch=args.batch, steps=args.steps,
        warmup_steps=10, device=args.device)
    sess.run(args.steps)
    losses = sess.losses
    print(json.dumps({"first_loss": losses[0], "last_loss": losses[-1],
                      "steps": len(losses), "comm_bytes": sess.comm_bytes,
                      "device": str(sess.model.device)}))


if __name__ == "__main__":
    main()
