"""The port's side of the dry run's gloo checks: one rank of P pods of
(D, M) meshes takes one step of SMOKE paper-350m under the dry run's
counters (``analysis/cost.py``), run in a process of its own by
``spawn_pods``.  Kept apart from the test files, which import JAX: a
spawned rank imports this module by name and nothing of the reference."""
import torch

from repro_torch.analysis.cost import Counters
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.memory import state_bytes
from repro_torch.launch.mesh import split_fleet_mesh, split_mesh
from repro_torch.models.registry import build_model

ARCH = "paper-350m"
SEQ, BATCH = 32, 4


def run_config() -> RunConfig:
    return RunConfig(model=SMOKE_ARCHS[ARCH],
                     shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     warmup_steps=1, total_steps=50)


def step_rank(world, P, D, M):
    """One rank: the Trainer from seed 0, one step of the strategy's
    representative kind under the default plan on the pod's rows of the
    pipeline's first batch, counted.  Returns the
    FLOPs, the state bytes and the collectives by op and tier of the
    rank's groups' byte log."""
    torch.set_num_threads(1)
    if P > 1:
        ctx, pods = split_fleet_mesh(world, P, D, M)
    else:
        ctx, pods = split_mesh(world, D, M), None
    run = run_config()
    tr = Trainer(build_model(run.model, run, device="cpu", ctx=ctx), run,
                 strategy="acesync", pods=pods)
    state = tr.init_state(0)
    ep = tr.exec_plan(tr.default_plan(bandwidth_mbps=50.0))
    pipe = TokenPipeline(tr.model, run.shape, seed=0,
                         pod=0 if pods is None else pods.rank, n_pods=P)
    batch = {k: torch.from_numpy(v) for k, v in pipe.host_batch(0).items()}
    with Counters(ctx.world.log) as c:
        tr.step(state, batch, ep, tr.strategy.representative_kind)
    return {"rank": world.rank, "flops": c.report.flops,
            "state_bytes": state_bytes(state),
            "collective_bytes": c.report.collective_bytes,
            "collective_count": c.report.collective_count}
