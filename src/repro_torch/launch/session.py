"""TrainSession: the one-call facade over model build + trainer + host
loop — port of ``repro/launch/session.py``::

    from repro_torch.launch.session import TrainSession

    sess = TrainSession.from_config("paper-350m", strategy="acesync",
                                    smoke=False, seq_len=1024, batch=8)
    sess.run(8)
    print(sess.losses[-1], sess.comm_bytes)

Runs on the card (``device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.train import TrainLoop
from repro_torch.models.registry import build_model
from repro_torch.strategies import SyncStrategy


class TrainSession:
    """Owns (model, run, loop, pipeline, state) for one training run."""

    def __init__(self, model, run: RunConfig,
                 strategy: Union[str, SyncStrategy] = "acesync",
                 n_edge_devices: int = 8, seed: int = 0):
        self.model = model
        self.run_config = run
        self.loop = TrainLoop(model, run, strategy=strategy,
                              n_edge_devices=n_edge_devices, seed=seed)
        self.pipeline = TokenPipeline(model, run.shape, seed=seed)
        self.state = None

    @classmethod
    def from_config(cls, arch: str,
                    strategy: Union[str, SyncStrategy] = "acesync", *,
                    smoke: bool = True, seq_len: int = 256, batch: int = 8,
                    steps: int = 100, n_edge_devices: int = 8,
                    seed: int = 0, device="cuda",
                    **run_kw) -> "TrainSession":
        """Build a session from an architecture name + strategy spec."""
        cfg = (SMOKE_ARCHS if smoke else ARCHS)[arch]
        shape = ShapeConfig("session", seq_len, batch, "train")
        run_kw.setdefault("warmup_steps", max(2, steps // 10))
        run = RunConfig(model=cfg, shape=shape, total_steps=steps, **run_kw)
        model = build_model(cfg, run, device=device)
        return cls(model, run, strategy=strategy,
                   n_edge_devices=n_edge_devices, seed=seed)

    @property
    def trainer(self):
        return self.loop.trainer

    @property
    def strategy(self) -> SyncStrategy:
        return self.loop.strategy

    def init(self):
        """Initialise fresh state (checkpoint restore is a later slice)."""
        if self.state is None:
            self.state = self.trainer.init_state(self.run_config.seed)
        return self.state

    def run(self, n_steps: Optional[int] = None,
            log_every: int = 10) -> "TrainSession":
        """Run n_steps (default: the RunConfig total) of the control loop."""
        self.init()
        self.state = self.loop.run_steps(
            self.state, self.pipeline,
            n_steps if n_steps is not None else self.run_config.total_steps,
            log_every=log_every)
        return self

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
