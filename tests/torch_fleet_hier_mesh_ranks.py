"""The port's side of the two-tier fleet of meshes tests: one rank of
C clusters x E members, each member a D x M mesh, run in a process of its
own by ``spawn_fleet_mesh(..., n_edge=E)``.  Kept apart from the test
files, which import JAX: a spawned rank imports this module by name and
nothing of the reference."""
import numpy as np
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.codecs import build_codec
from repro_torch.configs.base import ACESyncConfig
from repro_torch.core import planexec
from repro_torch.core import sync as S
from repro_torch.core.compression import Level
from repro_torch.core.planexec import INTRA_INT8
from repro_torch.core.scheduler import SyncPlan
from repro_torch.launch.session import TrainSession
from repro_torch.models.registry import build_model

from torch_fleet_mesh_ranks import crc, run_config

#: the sync round's plan: one leaf per rung on every device (not all block
#: multiples); INT8 and INT4 are the rungs a tier grid makes two-tier
LEVELS = (("INT8", 1.0, 8), ("TOPK10", 0.10, 8), ("SIGN1", 1.0, 1),
          ("INT4", 1.0, 4), ("FULL", 1.0, 16), ("SKIP", 0.0, 0))
SIZES = (4096 + 17, 3072, 2048, 4096, 2048, 700)
TWO_TIER_RUNGS = (0, 3)
GAMMA = 0.9
#: the tier grids forced (``hier_override`` 1: the bf16 intra stage, 2: the
#: INT8 one) and the cross tier's exchange (-1 one-shot, 2 a 2-chunk ring)
MODES = (1, 2)
RINGS = (-1, 2)
#: the session: edge devices clustered, ``PRE_SYNC`` local steps, a
#: delta_sync in the iteration of the last of them, a replan that
#: re-clusters, another delta_sync, ``STEPS_RUN`` steps in all
N_EDGE_DEVICES, PRE_SYNC, STEPS_RUN = 16, 3, 6


def omega(n: int) -> tuple:
    return tuple(float(x) for x in np.arange(1, n + 1) / (n * (n + 1) / 2))


def sync_inputs(n_dev: int):
    """Per device (world rank) seeded gradients and residuals: one
    (n_dev, n) array per leaf each."""
    r = np.random.RandomState(11)
    g = [r.randn(n_dev, n).astype(np.float32) for n in SIZES]
    e = [(r.randn(n_dev, n) * 0.3).astype(np.float32) for n in SIZES]
    return g, e


def tier_bytes(pods, since: int) -> tuple:
    """(cross, intra) payload bytes this rank received in log entries
    ``since``: its (d, m)'s fleet group's and cross sub-group's against its
    intra sub-group's (the pod means' reductions left out)."""
    new = pods.log[since:]
    cross = sum(x["bytes"] for x in new
                if x["tier"] in ("pod", "cross") and x["op"] != "reduce")
    intra = sum(x["bytes"] for x in new if x["tier"] == "intra")
    return cross, intra


def priced(ep, pods) -> tuple:
    """(cross, intra) bytes of exec plan ``ep`` priced on the rank's local
    layout: ``sig_wire_bytes`` with the tier grid at the cluster count and
    ``sig_intra_bytes``."""
    return (planexec.exec_wire_bytes(ep, pods.size, n_cross=pods.n_cross),
            planexec.exec_intra_bytes(ep, pods.n_edge))


# ---------------------------------------------------------------------------
# (a) the sync round
# ---------------------------------------------------------------------------


def sync_rank(ctx, pods):
    """One rank: ``sync_tree`` of its own seeded leaves under the plan of
    ``LEVELS`` for each forced tier grid and cross-tier exchange — the
    aggregate, residuals, bytes per tier logged and priced — and, per
    tier grid, the cluster aggregate each two-tier rung's cross tier
    re-encodes (the intra stage alone, for the fold bound)."""
    torch.set_num_threads(1)
    F, E, n = pods.size, pods.n_edge, ctx.D * ctx.M
    w = pods.rank * n + ctx.rank
    g, e = sync_inputs(F * n)
    levels = tuple(Level(*x) for x in LEVELS)
    plan = SyncPlan(tuple(range(len(levels))), levels, omega(F), 1)
    tree = {f"p{i}": torch.from_numpy(x[w].copy()) for i, x in enumerate(g)}
    errs = {f"p{i}": torch.from_numpy(x[w].copy()) for i, x in enumerate(e)}
    out = {"world": w, "slot": (pods.rank // E, pods.intra.rank,
                                pods.cross.rank),
           "coords": (pods.rank, ctx.d, ctx.m), "rounds": {}, "agg_c": {}}
    for mode in MODES:
        for ring in RINGS:
            ep = planexec.build_exec_plan(plan, SIZES, n_pods=F, n_edge=E,
                                          hier=mode, ring=ring,
                                          device="cpu")
            since = len(pods.log)
            agg, ne = S.sync_tree(tree, errs, ep, gamma=GAMMA, pods=pods)
            out["rounds"][(mode, ring)] = {
                "agg": {k: v.numpy() for k, v in agg.items()},
                "err": {k: v.numpy() for k, v in ne.items()},
                "bytes": tier_bytes(pods, since), "priced": priced(ep, pods),
                "hier": list(ep.hier), "chunks": list(ep.chunks)}
        om = torch.tensor(omega(F), dtype=torch.float32)
        inner = build_codec("int8" if mode == INTRA_INT8 else "full")
        for i in TWO_TIER_RUNGS:
            agg_c, _ = inner.ef_sync(
                tree[f"p{i}"], errs[f"p{i}"],
                om.reshape(F // E, E)[pods.rank // E], om[pods.rank],
                gamma=GAMMA, n_pods=E, pods=pods.intra)
            out["agg_c"][(mode, i)] = agg_c.numpy()
    return out


# ---------------------------------------------------------------------------
# (b) training and (c) its checkpoint
# ---------------------------------------------------------------------------


def session_rank(ctx, pods, init, ckpt_dir):
    """One rank of (2, 2, 1, 2): SMOKE paper-350m (f32) through
    TrainSession under ``acesync_hier`` from the reference's initial state
    (``init``, an npz of its flat ``state0/...``) for ``STEPS_RUN`` steps,
    every step recorded (H, the plan's levels, tier grid and omega, the
    clusters, and after a sync its bytes per tier beside the priced ones
    and the CRC of each parameter shard); this rank's shards before the
    first sync; the state checkpointed at the end."""
    torch.set_num_threads(1)
    ref = np.load(init)
    state0 = {k[len("state0/"):]: ref[k] for k in ref.files
              if k.startswith("state0/")}
    run = run_config("paper-350m", pods.size, ckpt_dir=ckpt_dir,
                     acesync=ACESyncConfig(sync_interval_init=3,
                                           replan_every=3))
    model = build_model(run.model, run, device="cpu", ctx=ctx)
    sess = TrainSession(model, run, strategy="acesync_hier", pods=pods,
                        n_edge_devices=N_EDGE_DEVICES)
    tr, loop = sess.trainer, sess.loop
    sess.state = convert.state_from_reference(state0, tr)
    recs, pre, real = [], {}, tr.step

    def step(state, batch, plan, kind="grad_sync"):
        if kind != "local" and not pre:
            pre.update(convert.rank_shards(state, tr))
        since = len(pods.log)
        new, m = real(state, batch, plan, kind)
        rec = {"step": loop._host_step, "kind": kind, "H": loop._H,
               "levels": list(plan.level_idx), "hier": list(plan.hier or ()),
               "omega": [float(x) for x in plan.omega],
               "clusters": list(loop.clusters.assignments),
               "updates": loop.clusters.updates}
        if kind == "delta_sync":
            ep = tr.exec_plan(plan)
            rec["bytes"] = tier_bytes(pods, since)
            rec["priced"] = priced(ep, pods)
            rec["tier_grid"] = [list(h) for h in (
                ep.seg_hier if ep.segmented else (ep.hier,))]
            rec["params"] = [crc(x) for x in T.leaves(new["params"])]
        recs.append(rec)
        return new, m

    tr.step = step
    sess.run(STEPS_RUN, log_every=0)
    sess.save_now()
    sess.finish()
    return {"pod": pods.rank, "rank": ctx.rank,
            "slot": (pods.rank // pods.n_edge, pods.rank % pods.n_edge),
            "n_edge": tr.n_edge, "hier_enabled": tr.scheduler.hier_enabled,
            "pre": pre, "steps": recs, "losses": sess.losses,
            "history": [{k: h[k] for k in ("loss", "grad_norm") if k in h}
                        for h in sess.history],
            "replans": loop.device_replans,
            "saved": convert.rank_shards(sess.state, tr),
            "step": int(sess.state["step"])}
