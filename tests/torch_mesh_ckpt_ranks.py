"""The port's side of the mesh-checkpoint tests: one rank of a ("data",
"model") mesh, run in a process of its own by ``spawn_mesh``.  Kept apart
from the test files, which import JAX: a spawned rank imports this module
by name and nothing of the reference.  Results cross the process boundary
as numpy arrays and Python values."""
import dataclasses
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer, MeshLayout
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ACESyncConfig, RunConfig, ShapeConfig
from repro_torch.core.trainer import Trainer
from repro_torch.launch.session import TrainSession
from repro_torch.models.registry import build_model
from repro_torch.runtime import faults as F
from torch_mesh_train_ranks import BATCH, LR, SEQ, run_config

#: the step the reference's state is checkpointed at (after two steps)
STEP = 2
#: the loop cases: the arch, the uninterrupted run's steps, the cadence;
#: a checkpoint of ANOTHER_ARCH (the same leaves, other shapes) restored
#: into a session of SAME_TREE_ARCH
LOOP_ARCH, LOOP_STEPS, LOOP_EVERY = "qwen3-8b", 4, 2
ANOTHER_ARCH, SAME_TREE_ARCH = "starcoder2-3b", "paper-350m"


def _step_dir(d, step) -> Path:
    return Path(d) / f"step_{step:08d}"


def ckpt_rank(ctx, archs, tmp, loop=True):
    """One rank: for each arch, its state loaded from the reference's
    (``<arch>_state.npz``, the reference's state after ``STEP`` steps),
    saved on the mesh to ``port/<arch>`` with the save's numbers, and the
    reference's own checkpoint (``ref/<arch>``) restored onto the rank
    (:func:`convert.rank_shards` of it and its extras); then, with
    ``loop``, the loop cases (:func:`loop_cases`)."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    out = {"rank": ctx.rank, "archs": {}}
    for arch in archs:
        run = run_config(arch)
        tr = Trainer(build_model(run.model, run, device="cpu", ctx=ctx), run,
                     strategy="acesync")
        flat = dict(np.load(tmp / f"{arch}_state.npz"))
        mesh = MeshLayout(ctx.world, tr.state_layout)
        ck = Checkpointer(str(tmp / "port" / arch), mesh=mesh)
        ck.save(STEP, convert.state_from_reference(flat, tr),
                extras={"arch": arch}, blocking=True)
        got, extras = Checkpointer(str(tmp / "ref" / arch),
                                   mesh=mesh).restore(tr.init_state(99))
        out["archs"][arch] = {"restored": convert.rank_shards(got, tr),
                              "extras": extras, "save": dict(ck.last_save)}
    if loop:
        out["loop"] = loop_cases(ctx, tmp)
    return out


def restore_rank(ctx, arch, ckpt_dir):
    """One rank: the checkpoint in ``ckpt_dir`` restored onto it through
    a session of ``arch`` (f32 SMOKE); its :func:`convert.rank_shards`."""
    torch.set_num_threads(1)
    sess = loop_session(ctx, ckpt_dir, arch=arch)
    sess.init()
    return convert.rank_shards(sess.state, sess.trainer)


def loop_session(ctx, ckpt_dir, arch=LOOP_ARCH, every=LOOP_EVERY):
    """A TrainSession of ``arch``'s f32 SMOKE config on ``ctx``'s mesh
    (None: one process) checkpointing to ``ckpt_dir`` every ``every``
    steps, replanning every 2."""
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS[arch],
                                              dtype="float32"),
                    shape=ShapeConfig("session", SEQ, BATCH, "train"),
                    lr=LR, warmup_steps=1, total_steps=50,
                    ckpt_dir=str(ckpt_dir), ckpt_every=every,
                    acesync=ACESyncConfig(replan_every=2))
    return TrainSession(build_model(run.model, run, device="cpu", ctx=ctx),
                        run, strategy="acesync", blocking_replans=True)


def loop_bits(sess) -> dict:
    """The rank's state shards and the loop's host state."""
    lp = sess.loop
    return {"shards": {k: v[0] for k, v in convert.rank_shards(
                sess.state, sess.trainer).items()},
            "host": (list(lp.plan.level_idx), lp.plan.sync_interval, lp._H,
                     lp._steps_since_sync,
                     sess.trainer.scheduler.sync_interval,
                     int(sess.state["step"])),
            "losses": sess.losses}


def loop_cases(ctx, tmp: Path) -> dict:
    """The loop on the mesh: (iv) run A trains ``LOOP_STEPS`` steps
    checkpointing every ``LOOP_EVERY`` to ``A``; run B, a fresh session
    over ``B`` holding only A's step-2 checkpoint, resumes there and
    trains to the same step; (v) a copy ``C`` of A with the step-4
    checkpoint's largest leaf bit-rotted restores on every rank; (vi) a
    shard write that fails on rank 1 (every attempt) fails the save on
    every rank, the step-1 checkpoint before it intact, and a later prune
    removes the ``.tmp``; (vii) a checkpoint of ``ANOTHER_ARCH`` restored
    into a session of ``SAME_TREE_ARCH``."""
    world, out = ctx.world, {}
    a = loop_session(ctx, tmp / "A")
    a.run(LOOP_STEPS, log_every=0)
    a.finish()
    out["a"] = loop_bits(a)
    last = LOOP_STEPS // LOOP_EVERY * LOOP_EVERY
    if ctx.rank == 0:
        shutil.copytree(_step_dir(tmp / "A", LOOP_EVERY),
                        _step_dir(tmp / "B", LOOP_EVERY))
        shutil.copytree(tmp / "A", tmp / "C")
        d = _step_dir(tmp / "C", last)
        biggest = max((n for n in os.listdir(d) if n.startswith("leaf_")),
                      key=lambda n: (d / n).stat().st_size)
        assert F.corrupt_checkpoint_leaf(
            str(tmp / "C"), int(biggest.split("_")[1].split(".")[0]),
            step=last)
        tr = Trainer(build_model(SMOKE_ARCHS[ANOTHER_ARCH], run_config(
            ANOTHER_ARCH), device="cpu"), run_config(ANOTHER_ARCH))
        Checkpointer(str(tmp / "other")).save(3, tr.init_state(0),
                                              blocking=True)
    world.barrier()
    b = loop_session(ctx, tmp / "B")
    b.init()
    out["b_restored"] = int(b.state["step"])
    b.run(LOOP_STEPS - out["b_restored"], log_every=0)
    b.finish()
    out["b"] = loop_bits(b)
    c = loop_session(ctx, tmp / "C")
    c.init()
    out["c"] = (int(c.state["step"]), list(c.loop.ckpt.corrupt_steps))
    # (vi) a failed shard write on rank 1
    ck = Checkpointer(str(tmp / "F"),
                      mesh=MeshLayout(world, b.trainer.state_layout))
    ck.BACKOFF_S = 0.001
    ck.save(1, b.state, blocking=True)
    if ctx.rank == 1:
        def failing(*args):
            raise OSError("injected shard write failure")
        ck._write_shards = failing
    ck.save(2, b.state)
    try:
        ck.wait()
        err = None
    except RuntimeError as e:
        err = str(e)
    tmp_dir = tmp / "F" / "step_00000002.tmp"
    fail = {"err": err, "latest": ck.latest_step(),
            "verified": ck.verify(1, deep=True), "tmp_left": tmp_dir.is_dir()}
    world.barrier()
    ck.prune(keep=3)
    world.barrier()
    fail["tmp_after_prune"] = tmp_dir.is_dir()
    out["fail"] = fail
    # (vii) another arch's checkpoint
    try:
        loop_session(ctx, tmp / "other", arch=SAME_TREE_ARCH).init()
        out["other"] = None
    except ValueError as e:
        out["other"] = str(e)
    return out


def fault_rank(ctx, tmp):
    """One rank of a session that checkpoints every 2 steps with a
    checkpoint corruption scheduled at step 3, logging every step: the
    corruptions this rank made and what it printed."""
    import contextlib
    import io
    torch.set_num_threads(1)
    calls, real = [], F.corrupt_checkpoint_leaf

    def recording(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    F.corrupt_checkpoint_leaf = recording
    sess = loop_session(ctx, Path(tmp) / "faults")
    sess.loop.faults = F.FaultSchedule([F.FaultEvent(3, F.CORRUPT_CKPT, 0)])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        sess.run(4, log_every=1)
        sess.finish()
    return {"calls": len(calls), "printed": printed.getvalue()}


def sub_mesh_rank(world):
    """One process of a fleet of four: a (1, 2) mesh of fleet ranks 2 and
    3 and a (2, 1) mesh of ranks 0 and 1, made by every process in one
    order; on each of its meshes this rank's (mesh rank, d, m), the sum
    of fleet rank + 1 over each axis and the axis groups' fleet ranks."""
    from repro_torch.launch.mesh import sub_mesh
    torch.set_num_threads(1)
    out = {}
    for name, members, D, M in (("a", [2, 3], 1, 2), ("b", [0, 1], 2, 1)):
        ctx = sub_mesh(world, members, D, M)
        if ctx is None:
            continue
        x = torch.tensor([world.rank + 1.0])
        out[name] = (ctx.rank, ctx.d, ctx.m,
                     float(ctx.all_reduce_sum(x, "data")),
                     float(ctx.all_reduce_sum(x, "model")),
                     ctx.data.ranks, ctx.model.ranks, ctx.world.ranks)
    world.barrier()
    return out
