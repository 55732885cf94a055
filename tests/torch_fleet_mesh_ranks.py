"""The port's side of the pods x ("data", "model") tests: one rank of P
pods of D x M meshes, run in a process of its own by ``spawn_fleet_mesh``
(or one pod process by ``spawn_pods``, one card per pod).  Kept apart
from the test files, which import JAX: a spawned rank imports this module
by name and nothing of the reference."""
import dataclasses
import zlib

import numpy as np
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import Checkpointer, MeshLayout
from repro_torch.codecs import plan_wire_bytes
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ACESyncConfig, RunConfig, ShapeConfig
from repro_torch.core import planexec
from repro_torch.core import sync as S
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.trainer import Trainer
from repro_torch.launch.session import TrainSession
from repro_torch.models.registry import build_model
from repro_torch.runtime.faults import FaultSchedule

#: the sync round's leaves on every device: one per rung of the ladder
#: (not all block multiples)
SIZES = (6144 * 3 + 17, 8192, 3000, 6144, 2048, 4100, 700, 1500)
GAMMA = 0.9
#: the sync round's exec plans by their ``ring`` argument: the one-shot
#: exchange and the ring forced to 2 chunks
RINGS = {"one_shot": -1, "k2": 2}
#: the train shape of the session cases: the global batch, split over the
#: pods (each pod's rows are a (1, 2) mesh's whole batch); learning rate
SEQ, BATCH, LR = 32, 8, 1e-2
#: the session's steps: ``PRE_SYNC`` local steps, a delta_sync in the
#: iteration of the last of them, a replan, another delta_sync
PRE_SYNC, STEPS_RUN = 3, 6
#: the elastic run: pod KILLED preempted at step KILL, back at REJOIN,
#: checkpoints every CKPT_EVERY steps, STEPS steps, ROWS rows per pod
KILLED, KILL, REJOIN, CKPT_EVERY, STEPS, ROWS = 1, 4, 8, 5, 12, 2


def omega(P: int) -> tuple:
    return tuple(float(x) for x in np.arange(1, P + 1) / (P * (P + 1) / 2))


def sync_inputs(n_dev: int):
    """Per device (world rank) seeded gradients and residuals: one
    (n_dev, n) array per leaf each."""
    r = np.random.RandomState(11)
    g = [r.randn(n_dev, n).astype(np.float32) for n in SIZES]
    e = [(r.randn(n_dev, n) * 0.3).astype(np.float32) for n in SIZES]
    return g, e


def crc(t) -> int:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return zlib.crc32(np.ascontiguousarray(a).view(np.uint8))


def priced(ep, P: int) -> tuple:
    """(the gather and ring rungs' ``plan_wire_bytes``, FULL's
    ``FullCodec.wire_bytes``, the bound on FULL's shard padding: fewer
    than 4 (P - 1) bytes a FULL piece whose size P does not divide)."""
    grids = ep.seg_sig if ep.segmented else (ep.sig,)
    pay = full = pad = 0
    for sig in grids:
        for r, n_rows in enumerate(sig):
            if not n_rows:
                continue
            lv, n = ep.levels[r], n_rows * ep.block
            if lv.codec.name == "full":
                full += lv.wire_bytes(n, P)
                pad += 4 * (P - 1) if n % P else 0
            else:
                pay += lv.wire_bytes(n, P)
    return pay, full, pad


def logged(pods, since: int) -> tuple:
    """(gather + ring, full) bytes the pod tier logged since entry
    ``since``."""
    new = [x for x in pods.log[since:] if x["tier"] == "pod"]
    return (sum(x["bytes"] for x in new if x["op"] in ("gather", "ring")),
            sum(x["bytes"] for x in new if x["op"] == "full"))


def wire_bytes(tr, plan) -> dict:
    """``plan_wire_bytes`` of the rank's local layout: on the exec plan's
    (padded) bucket signatures, one per backward segment (``wire``), and
    on the exact one (``exact``, which a plan that is not adaptive
    executes)."""
    ep = tr.exec_plan(plan)
    return {"wire": sum(planexec.sig_wire_bytes(sig, ep.levels, tr.n_pods,
                                                ep.block)
                        for sig in (ep.seg_sig if ep.segmented
                                    else (ep.sig,))),
            "exact": plan_wire_bytes(plan, tr.local_sizes, tr.n_pods,
                                     use_sig=False),
            "adaptive": bool(plan.adaptive)}


def run_config(arch: str, P: int, **kw) -> RunConfig:
    """f32 compute (the reference's one-pod mesh runs compare to it), the
    global batch ``BATCH`` rows per pod count ``P`` of 2."""
    return RunConfig(model=dataclasses.replace(SMOKE_ARCHS[arch],
                                               dtype="float32"),
                     shape=ShapeConfig("t", SEQ, BATCH // 2 * P, "train"),
                     lr=LR, warmup_steps=1, total_steps=50, **kw)


def seeded_params(model, pod: int) -> dict:
    """Global parameters of ``model`` drawn from a seed per pod."""
    shapes = T.leaves_with_path(model.global_param_shapes())
    r = np.random.RandomState(100 + pod)
    return {T.path_str(p): (r.randn(*s) * 0.02).astype(np.float32)
            for p, s in shapes}


# ---------------------------------------------------------------------------
# (a) the sync round and (b) the divergence
# ---------------------------------------------------------------------------


def sync_rank(ctx, pods, rings, divergence):
    """One rank: the sync round on its own seeded leaves under every rung
    (one leaf each) through each exec plan of ``rings``, the aggregate,
    residuals and pod-tier bytes; with ``divergence`` the eq-(9) estimate
    of SMOKE paper-350m with pod-seeded parameters."""
    torch.set_num_threads(1)
    P, n = pods.size, ctx.D * ctx.M
    w = pods.rank * n + ctx.rank
    g, e = sync_inputs(P * n)
    plan = Scheduler(ACESyncConfig(), list(SIZES), P,
                     device="cpu").plan_from_levels(list(range(len(SIZES))),
                                                    omega(P))
    out = {"coords": (pods.rank, ctx.d, ctx.m), "world": w, "rounds": {}}
    for name, ring in rings.items():
        ep = planexec.build_exec_plan(plan, list(SIZES), n_pods=P,
                                      ring=ring, device="cpu")
        tree = {f"p{i}": torch.from_numpy(x[w].copy())
                for i, x in enumerate(g)}
        errs = {f"p{i}": torch.from_numpy(x[w].copy())
                for i, x in enumerate(e)}
        since = len(pods.log)
        agg, ne = S.sync_tree(tree, errs, ep, gamma=GAMMA, pods=pods)
        out["rounds"][name] = {
            "agg": {k: v.numpy() for k, v in agg.items()},
            "err": {k: v.numpy() for k, v in ne.items()},
            "logged": logged(pods, since), "priced": priced(ep, P),
            "chunks": list(ep.chunks)}
    if divergence:
        out["divergence"] = divergence_of(ctx, pods)
    return out


def divergence_of(ctx, pods) -> float:
    """The pod-mean divergence estimate of SMOKE paper-350m (f32) whose
    parameters are drawn from a seed per pod, on a mesh rank (``ctx``) or
    one card (None)."""
    run = run_config("paper-350m", pods.size)
    model = build_model(run.model, run, device="cpu",
                        **({} if ctx is None else {"ctx": ctx}))
    tr = Trainer(model, run, strategy="acesync", pods=pods)
    convert.params_from_reference(
        convert.shard_params(seeded_params(model, pods.rank), model), model)
    return float(tr._divergence(model.param_tree()))


def divergence_pod(group):
    """One pod process with the whole model (one card per pod)."""
    torch.set_num_threads(1)
    return divergence_of(None, group)


# ---------------------------------------------------------------------------
# (c) sessions and (d) their checkpoint
# ---------------------------------------------------------------------------


def _record_steps(sess, pods, recs, pre):
    """Record every step of the session's trainer: the kind, H, plan and
    omega, and after a sync its pod-tier bytes beside the priced ones and
    the CRC of each parameter shard; this rank's shards of the state the
    first sync starts from into ``pre``."""
    tr, loop = sess.trainer, sess.loop
    real = tr.step

    def step(state, batch, plan, kind="grad_sync"):
        if kind != "local" and not pre:
            pre.update(convert.rank_shards(state, tr))
        since = len(pods.log)
        new, m = real(state, batch, plan, kind)
        rec = {"step": loop._host_step, "kind": kind, "H": loop._H,
               "P": tr.n_pods, "levels": list(plan.level_idx),
               "omega": [float(x) for x in plan.omega],
               "rows": list(loop._pipeline.rows)}
        if kind in ("delta_sync", "grad_sync"):
            rec["bytes"] = logged(pods, since) + priced(tr.exec_plan(plan),
                                                        tr.n_pods)
            rec.update(wire_bytes(tr, plan))
            rec["params"] = [crc(x) for x in T.leaves(new["params"])]
        recs.append(rec)
        return new, m
    tr.step = step


def session_rank(ctx, pods, archs, inits, ckpt_dir):
    """One rank of (2, 1, 2): for each arch a TrainSession from the
    reference's initial state (``inits[arch]``, an npz of its flat
    ``state0/...``) for ``STEPS_RUN`` steps, every step recorded, and this
    rank's shards before the first sync; the first arch's state is
    checkpointed at the end."""
    torch.set_num_threads(1)
    out = {"pod": pods.rank, "rank": ctx.rank, "archs": {}}
    for i, arch in enumerate(archs):
        ref = np.load(inits[arch])
        state0 = {k[len("state0/"):]: ref[k] for k in ref.files
                  if k.startswith("state0/")}
        run = run_config(arch, pods.size, ckpt_dir=f"{ckpt_dir}/{arch}",
                         acesync=ACESyncConfig(sync_interval_init=3,
                                               replan_every=3))
        model = build_model(run.model, run, device="cpu", ctx=ctx)
        sess = TrainSession(model, run, strategy="acesync", pods=pods)
        sess.state = convert.state_from_reference(state0, sess.trainer)
        recs, pre = [], {}
        _record_steps(sess, pods, recs, pre)
        sess.run(STEPS_RUN, log_every=0)
        res = {"pre": pre, "steps": recs, "losses": sess.losses,
               "history": [{k: h[k] for k in ("loss", "grad_norm")
                            if k in h} for h in sess.history],
               "local_sizes": sess.trainer.local_sizes,
               "replans": sess.loop.device_replans}
        if i == 0:
            sess.save_now()
            sess.finish()
            res["saved"] = convert.rank_shards(sess.state, sess.trainer)
        out["archs"][arch] = res
    return out


def restore_rank(ctx, pods, arch, ckpt_dir):
    """This rank's shards of the checkpoint in ``ckpt_dir`` restored on
    its fleet (``ctx`` None: one card per pod)."""
    torch.set_num_threads(1)
    run = run_config(arch, pods.size)
    model = build_model(run.model, run, device="cpu",
                        **({} if ctx is None else {"ctx": ctx}))
    tr = Trainer(model, run, strategy="acesync", pods=pods)
    mesh = None if ctx is None else MeshLayout(ctx.world, tr.state_layout)
    state, extras = Checkpointer(ckpt_dir, pods=pods, mesh=mesh).restore(
        tr.init_state(0))
    return {"pod": pods.rank, "shards": convert.rank_shards(state, tr),
            "step": int(state["step"])}


def restore_pod(group, arch, ckpt_dir):
    return restore_rank(None, group, arch, ckpt_dir)


# ---------------------------------------------------------------------------
# (e) elastic membership
# ---------------------------------------------------------------------------


def elastic_rank(ctx, pods, ckpt_dir):
    """One rank of (3, 1, 2): SMOKE paper-350m (f32) through TrainSession
    with pod ``KILLED`` preempted at step ``KILL`` and back at ``REJOIN``
    (checkpoints every ``CKPT_EVERY`` steps); every step recorded, the
    state's CRCs around each transition and at each save; then pods 0
    and 1 restore the last checkpoint (written by three pods) as a P = 2
    fleet of meshes."""
    torch.set_num_threads(1)
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS["paper-350m"],
                                              dtype="float32"),
                    shape=ShapeConfig("t", SEQ, ROWS * pods.size, "train"),
                    lr=LR, warmup_steps=1, total_steps=50,
                    ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                    acesync=ACESyncConfig(replan_every=4))
    sess = TrainSession(
        build_model(run.model, run, device="cpu", ctx=ctx), run,
        strategy="acesync", pods=pods,
        fault_schedule=FaultSchedule.preempt_and_rejoin(KILLED, KILL,
                                                        REJOIN))
    loop = sess.loop
    recs, out = [], {"saved": {}, "transfers": []}

    def leaves_crc(state):
        return [crc(x) for _, x in T.reference_leaves_with_path(state)]

    real_trainer_for = loop._trainer_for

    def trainer_for(group):
        tr = real_trainer_for(group)
        if not getattr(tr, "_recorded", False):
            tr._recorded = True
            real = tr.step

            def step(state, batch, plan, kind="grad_sync"):
                since = len(pods.log)
                new, m = real(state, batch, plan, kind)
                rec = {"step": loop._host_step, "kind": kind,
                       "P": tr.n_pods, "levels": list(plan.level_idx),
                       "omega": [float(x) for x in plan.omega],
                       "batch": loop._pipeline.shape.global_batch,
                       "rows": list(loop._pipeline.rows)}
                if kind == "delta_sync":
                    rec["bytes"] = (logged(group, since)
                                    + priced(tr.exec_plan(plan), tr.n_pods))
                    rec.update(wire_bytes(tr, plan))
                    rec["params"] = [crc(x) for x in T.leaves(new["params"])]
                recs.append(rec)
                return new, m
            tr.step = step
        return tr

    loop._trainer_for = trainer_for
    trainer_for(pods)           # the first membership's trainer
    transfer = loop._transfer_state

    def recorded_transfer(state, tr, grp, joining):
        before = None if state is None else leaves_crc(state)
        new = transfer(state, tr, grp, joining)
        out["transfers"].append({
            "step": loop._host_step, "joining": list(joining),
            "member": grp is not None, "before": before,
            "after": None if new is None else leaves_crc(new)})
        return new

    loop._transfer_state = recorded_transfer
    save = loop.ckpt.save

    def recorded_save(step_no, state, extras=None, blocking=False):
        out["saved"][step_no] = leaves_crc(state)
        return save(step_no, state, extras=extras, blocking=blocking)

    loop.ckpt.save = recorded_save
    sess.init()
    sess.run(STEPS, log_every=0)
    sess.finish()
    last = STEPS // CKPT_EVERY * CKPT_EVERY
    # the last checkpoint (three pods' rows) restored as a P = 2 fleet
    sub = pods.regroup([pods.ranks[0], pods.ranks[1]])
    restored = None
    if sub is not None:
        tr = loop._trainer_for(sub)
        state, _ = Checkpointer(
            ckpt_dir, pods=sub,
            mesh=MeshLayout(ctx.world, tr.state_layout)).restore(
                tr.init_state(run.seed))
        restored = leaves_crc(state)
    return {"pod": pods.rank, "rank": ctx.rank, "steps": recs,
            "events": [(e["step"], e["n_pods"], e["members"])
                       for e in loop.membership_events],
            "losses": [(h["step"], h["loss"]) for h in sess.history
                       if "loss" in h],
            "saved": out["saved"], "last": last,
            "restored": restored, "transfers": out["transfers"],
            "finite": all(bool(torch.isfinite(x).all()) for x in
                          T.leaves(sess.model.param_tree()))}
