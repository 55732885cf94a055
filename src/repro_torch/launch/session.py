"""TrainSession: the one-call facade over model build + trainer + host
loop — port of ``repro/launch/session.py``::

    from repro_torch.launch.session import TrainSession

    sess = TrainSession.from_config("paper-350m", strategy="acesync",
                                    smoke=False, seq_len=1024, batch=8)
    sess.run(8)
    print(sess.losses[-1], sess.comm_bytes)

Runs on the card (``device="cuda"``) unless the caller asks for the CPU.
One session is one pod: with a pod group (``pods=``, see
:func:`repro_torch.launch.mesh.spawn_pods`) it runs on the group's device
and trains on its pod's rows of every global batch.  A hierarchical pod
group (``spawn_pods(..., n_edge=E)``) carries the fleet's cluster size
(``n_edge``) into the trainer, its scheduler and the clustering.  With a
``mesh`` (a rank's ``ShardCtx``, see
:func:`repro_torch.launch.mesh.spawn_mesh`) the session is one rank of a
within-pod ("data", "model") mesh: the model is built sharded on the
rank's device and every rank reads the whole global batch (the model
keeps its block); every rank checkpoints and restores its shards (see
:mod:`repro_torch.launch.train`), so :meth:`TrainSession.save_now` and
:meth:`TrainSession.finish` are called on every rank.  With both (a
rank of pods x ("data", "model"), see
:func:`repro_torch.launch.mesh.spawn_fleet_mesh`: ``pods`` the pods at
its (d, m)) every rank of pod p reads pod p's rows.

:meth:`TrainSession.init` resumes from the newest checkpoint in the run's
``ckpt_dir`` that verifies (a fresh state when there is none);
:meth:`TrainSession.finish` waits for the checkpoint writer (and raises
what it failed with); :meth:`TrainSession.save_now` checkpoints the
current step.  ``fault_schedule`` and ``blocking_replans`` go to the
loop (:class:`~repro_torch.launch.train.TrainLoop`).  With
``RunConfig.deterministic`` the session switches the process to
deterministic algorithms before the model is built
(:func:`apply_determinism`).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.train import TrainLoop
from repro_torch.models.registry import build_model
from repro_torch.strategies import SyncStrategy


def apply_determinism(run: RunConfig) -> None:
    """With ``run.deterministic``: deterministic algorithms, and cuBLAS's
    fixed workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, where the
    environment does not set it already).  cuBLAS reads the variable when
    it starts, at the first matmul on the card, so this runs before the
    model is built.  The switch is process-wide."""
    if run.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


class TrainSession:
    """Owns (model, run, loop, pipeline, state) for one training run."""

    def __init__(self, model, run: RunConfig,
                 strategy: Union[str, SyncStrategy] = "acesync",
                 n_edge_devices: int = 8, seed: int = 0, pods=None,
                 fault_schedule=None, blocking_replans: bool = False):
        self.model = model
        self.run_config = run
        self.pods = pods
        self.loop = TrainLoop(model, run, strategy=strategy,
                              n_edge_devices=n_edge_devices, seed=seed,
                              pods=pods, fault_schedule=fault_schedule,
                              blocking_replans=blocking_replans)
        self.pipeline = TokenPipeline(
            model, run.shape, seed=seed,
            pod=0 if pods is None else pods.rank,
            n_pods=1 if pods is None else pods.size)
        self.state = None

    @classmethod
    def from_config(cls, arch: str,
                    strategy: Union[str, SyncStrategy] = "acesync", *,
                    smoke: bool = True, seq_len: int = 256, batch: int = 8,
                    steps: int = 100, n_edge_devices: int = 8,
                    seed: int = 0, device="cuda", pods=None, mesh=None,
                    fault_schedule=None, blocking_replans: bool = False,
                    **run_kw) -> "TrainSession":
        """Build a session from an architecture name + strategy spec.
        ``batch`` is the global batch (split over the pods of ``pods``,
        whose device replaces ``device``; on a ``mesh`` rank, the rank's
        device)."""
        cfg = (SMOKE_ARCHS if smoke else ARCHS)[arch]
        shape = ShapeConfig("session", seq_len, batch, "train")
        run_kw.setdefault("warmup_steps", max(2, steps // 10))
        run = RunConfig(model=cfg, shape=shape, total_steps=steps, **run_kw)
        apply_determinism(run)
        if pods is not None:
            device = pods.device
        kw = {}
        if mesh is not None:
            device, kw = mesh.device, {"ctx": mesh}
        model = build_model(cfg, run, device=device, **kw)
        return cls(model, run, strategy=strategy,
                   n_edge_devices=n_edge_devices, seed=seed, pods=pods,
                   fault_schedule=fault_schedule,
                   blocking_replans=blocking_replans)

    @property
    def trainer(self):
        return self.loop.trainer

    @property
    def strategy(self) -> SyncStrategy:
        return self.loop.strategy

    def init(self):
        """Restore the newest checkpoint that verifies, or initialise
        fresh state."""
        if self.state is None and not self.loop.idle:
            self.state = self.loop.restore_or_init(self.run_config.seed,
                                                   self.pipeline)
        return self.state

    def run(self, n_steps: Optional[int] = None,
            log_every: int = 10) -> "TrainSession":
        """Run n_steps (default: the RunConfig total) of the control loop."""
        self.init()
        # the loop takes the state over (CPython moves a call's arguments
        # into the callee's frame), so the state it starts from — its
        # moments, anchor and residuals — is freed as soon as a step has
        # replaced it, not held by the session to the end of the run
        self.state = self.loop.run_steps(
            self.take_state(), self.pipeline,
            n_steps if n_steps is not None else self.run_config.total_steps,
            log_every=log_every)
        # the pipeline the loop drains (re-balanced by a membership change)
        self.pipeline = self.loop._pipeline
        return self

    def take_state(self):
        """The current state, handed over: the session lets go of it (its
        ``state`` is None until it is given one back)."""
        state, self.state = self.state, None
        return state

    def finish(self):
        """Wait for pending checkpoint writes (re-raises a failed one)."""
        self.loop.ckpt.wait()

    def save_now(self) -> int:
        """Checkpoint the current step (blocking); returns the step."""
        step = int(self.state["step"])
        if self.loop._pipeline is None:
            self.loop._pipeline = self.pipeline
        self.loop.ckpt.save(step, self.state,
                            extras=self.loop.ckpt_extras(), blocking=True)
        return step

    @property
    def history(self):
        return self.loop.history

    @property
    def losses(self):
        return [h["loss"] for h in self.loop.history if "loss" in h]

    @property
    def comm_bytes(self) -> float:
        """Cumulative pod-tier wire bytes (strategy-priced, per device)."""
        return self.loop.comm_bytes
