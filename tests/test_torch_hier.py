"""The port's two-tier hierarchy against the reference: the tier grid,
the hierarchical scheduler and cluster policies, ``ef_sync_hier``,
``sync_tree`` with a two-tier plan and ``acesync_hier`` training, on a
fleet of C clusters x E members.

* Grids (``hier_rung_mode``, ``exec_grid``, ``sig_wire_bytes``,
  ``sig_intra_bytes``, ``seg_grids``) and the ``Scheduler`` on a 2 x 2
  fleet, with the port's link constants set to the reference's TPU
  values for the test (cross tier ``LINK_BW`` = its ``DCN_BW``, intra
  tier ``INTRA_BW`` = its ``ICI_BW``), so that both rooflines read the
  same numbers: equal, element for element.
* ``ClusterState`` (policies, bottleneck bandwidth, fleet omega,
  snapshots) on the same seeded telemetry: equal.
* Fleets: the reference runs in subprocesses on ("pod", "edge") and
  (2, 2, 1) ("pod", "edge", "data") CPU meshes
  (``--xla_force_host_platform_device_count``), its kernels interpreted
  (``REPRO_FORCE_INTERPRET=1``); the port as one gloo process per fleet
  member (``spawn_pods(n_edge=E)``, ``file://`` rendezvous).  Inputs are
  made from seeds with numpy.  Checked, with their tolerances:

  - ``ef_sync_hier`` of INT8 and INT4 with the bf16 and the INT8 intra
    stage, the cross tier one-shot, on 2 x 2 and 2 x 3 (E = 3 folds the
    intra tier in int32 fixed point): residuals bit for bit.  The
    aggregate: with C = 2 the cross tier folds in float, and the
    reference's tier-2 weights are the constant ones of
    ``jnp.ones((n_cross,))``: XLA drops the multiplication by 1 and
    contracts the second cluster's ``q * s`` into the add,
    ``fma(q1, s1, round(q0 * s0))``, where the port's kernels round
    ``q1 * s1`` first (K5 / K6: ``fma(w, round(q * s), acc)``); both
    formulas, applied to the port's re-encoded cluster aggregates, give
    the two packages' bits exactly (ROADMAP R4).  So
    each entry may differ by one rounding of ``q1 * s1``: the test holds
    it within 2 ulp of sum_c absmax_c of the cluster aggregates' blocks,
    the bound tests/test_torch_ring.py states for R3.  The cross tier as
    a K = 2 ring: bit-identical to the port's own one-shot on every
    member, aggregate and residual, and to the reference's ring (which
    folds each cluster's own payload first, R3) within the same bound.
  - ``sync_tree`` of an INT8 / TOPK10 / SIGN1 / INT4 / FULL / SKIP plan
    with the two-tier rungs forced to either intra stage, cross tier
    one-shot and forced to a K = 2 ring: the ring bit-identical to the
    one-shot on every member; against the reference, the flat rungs
    (TOPK10, FULL, SKIP over the whole fleet) and every residual bit for
    bit, the two-tier rungs' aggregates within the bound above, SIGN1 (a
    flat rung; its block scale is summed in another order) within 8 ulp
    of the scale plus one fixed-point unit per member, as in
    test_torch_ring.py.  The bytes logged per tier equal the analytic
    cross-tier (``sig_wire_bytes(..., hier, n_cross=2)``) and intra
    (``sig_intra_bytes``) bytes.
  - ``acesync_hier``, 6 steps of paper-350m's smoke model (f32 compute)
    from the reference's initial state, ``TrainSession`` on both sides:
    the same plan and tier grid, fleet-mean losses within 1e-5 relative,
    the four members bit-identical after the ``delta_sync``, every
    parameter within 5e-2 of the reference's after it and at the end
    (the bound tests/test_torch_multipod.py states), and the bytes of the
    ``delta_sync`` per tier equal to the priced bytes of its executed
    plan.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
#: the reference's roofline constants (repro/launch/mesh.py,
#: repro/core/planexec.py), set on the port for the comparisons
REF_CONSTANTS = {"LINK_BW": 6.25e9, "INTRA_BW": 50e9, "HBM_BW": 819e9,
                 "RING_HOP_LATENCY_S": 10e-6, "RING_TARGET_CHUNK_S": 500e-6}
LADDER = (("FULL", 1.0, 16), ("INT8", 1.0, 8), ("INT4", 1.0, 4),
          ("TOPK25_INT8", 0.25, 8), ("TOPK10_INT8", 0.10, 8),
          ("SIGN1", 1.0, 1), ("TOPK1_INT8", 0.01, 8), ("SKIP", 0.0, 0))
#: the sync_tree plan: one leaf per rung (not all block multiples)
LEVELS = (("INT8", 1.0, 8), ("TOPK10", 0.10, 8), ("SIGN1", 1.0, 1),
          ("INT4", 1.0, 4), ("FULL", 1.0, 16), ("SKIP", 0.0, 0))
SIZES = (4096 + 17, 3072, 2048, 4096, 2048, 700)
SIGN_RUNG = 2
#: the rungs the forced tier grids make two-tier (INT8, INT4)
TWO_TIER_RUNGS = (0, 3)
SIGN_ULP = 8
#: ef_sync_hier's flat buffer: 4 blocks, the last one partial
N_FLAT = 4000
#: (codec, intra mode, cross chunks) of the ef_sync_hier cases
HIER_CASES = [(c, m, k) for c in ("int8", "int4") for m in (1, 2)
              for k in (0, 2)]
#: the cases with the cross tier one-shot, and as a K = 2 ring
ONE_SHOT_CASES = [c for c in HIER_CASES if not c[2]]
RING_CASES = [c for c in HIER_CASES if c[2]]
#: fleets (clusters, members) of the ef_sync_hier cases
FLEETS = ((2, 2), (2, 3))
SEQ = 32
LR = 1e-2
STEPS = (4, 2)              # run 4 steps (the delta_sync is the 4th), then 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-2


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _omega(n):
    return tuple(float(x) for x in np.arange(1, n + 1) / (n * (n + 1) / 2))


def _hier_inputs(n_fleet):
    r = np.random.RandomState(5)
    g = r.randn(n_fleet, N_FLAT).astype(np.float32)
    e = (r.randn(n_fleet, N_FLAT) * 0.3).astype(np.float32)
    return g, e


def _tree_inputs(n_fleet):
    r = np.random.RandomState(11)
    g = [r.randn(n_fleet, n).astype(np.float32) for n in SIZES]
    e = [(r.randn(n_fleet, n) * 0.3).astype(np.float32) for n in SIZES]
    return g, e


# ---------------------------------------------------------------------------
# grids, scheduler, clusters
# ---------------------------------------------------------------------------


def _patch_constants(monkeypatch):
    from repro_torch.core import planexec as tpe
    for k, v in REF_CONSTANTS.items():
        monkeypatch.setattr(tpe, k, v)


@pytest.mark.parametrize("n_cross,n_edge", [(2, 2), (2, 3), (3, 2), (4, 2),
                                            (1, 4), (4, 1)])
def test_tier_grid_matches_reference(monkeypatch, n_cross, n_edge):
    """hier_rung_mode per rung, and exec_grid / sig_wire_bytes /
    sig_intra_bytes / seg_grids over random plans: equal tuples."""
    from repro.core import planexec as jpe
    from repro.core.compression import Level as JLevel
    from repro_torch.core import planexec as tpe
    from repro_torch.core.compression import Level as TLevel
    _patch_constants(monkeypatch)
    jl = [JLevel(*x) for x in LADDER]
    tl = [TLevel(*x) for x in LADDER]
    assert (tpe.INTRA_FULL, tpe.INTRA_INT8) == (jpe.INTRA_FULL,
                                                jpe.INTRA_INT8)
    for cfg in (-1, 0, 1, 2):
        assert tpe.hier_override(cfg) == jpe.hier_override(cfg)
    for j, t in zip(jl, tl):
        for nb in (0, 1, 2, 7, 64, 1000, 4096, 50432, 196608, 443697):
            for hier in (None, -1, 0, 1, 2):
                assert (tpe.hier_rung_mode(t, nb, n_cross, n_edge,
                                           hier=hier)
                        == jpe.hier_rung_mode(j, nb, n_cross, n_edge,
                                              hier=hier)), (t.name, nb, hier)
    fleet = n_cross * n_edge
    r = np.random.RandomState(fleet * 7 + n_edge)
    for _ in range(12):
        idx = tuple(int(i) for i in r.randint(0, 8, size=11))
        sizes = tuple(int(s) for s in
                      np.exp(r.uniform(3, 19.5, size=11)).astype(np.int64))
        for growth in (None, 1.125):
            for ring in (None, -1, 2):
                for hier in (None, -1, 1, 2):
                    kw = dict(growth=growth, ring=ring, n_edge=n_edge,
                              hier=hier)
                    want = jpe.exec_grid(idx, sizes, jl, fleet, **kw)
                    got = tpe.exec_grid(idx, sizes, tl, fleet, **kw)
                    assert got == want, (idx, sizes, kw)
                    sig, _, hg = got
                    assert (tpe.sig_wire_bytes(sig, tl, fleet, hier=hg,
                                               n_cross=n_cross)
                            == jpe.sig_wire_bytes(sig, jl, fleet, hier=hg,
                                                  n_cross=n_cross))
                    assert (tpe.sig_intra_bytes(sig, tl, n_edge, hier=hg)
                            == jpe.sig_intra_bytes(sig, jl, n_edge,
                                                   hier=hg))
        for hier in (None, 2):
            got = tpe.seg_grids(idx, tpe.leaf_layout(sizes), tl, fleet,
                                1.125, None, True, n_edge=n_edge, hier=hier,
                                segments=2)
            want = jpe.seg_grids(idx, jpe.leaf_layout(sizes), jl, fleet,
                                 1.125, None, True, n_edge=n_edge,
                                 hier=hier, segments=2)
            assert got == want


def test_port_constants_pick_the_int8_intra_stage():
    """Under the port's own constants (both tiers the same gloo loopback
    on one card) the bf16 intra stage never hides under the cross tier:
    the roofline picks the INT8 gather + fold on the 2 x 2 fleet, where
    the reference's TPU constants pick the bf16 sum."""
    from repro.core import planexec as jpe
    from repro.core.compression import Level as JLevel
    from repro_torch.core import planexec as tpe
    from repro_torch.core.compression import Level as TLevel
    for name in ("INT8", "INT4"):
        lv = next(x for x in LADDER if x[0] == name)
        for nb in (1, 64, 4096, 443697):
            assert tpe.hier_rung_mode(TLevel(*lv), nb, 2, 2) \
                == tpe.INTRA_INT8
            assert jpe.hier_rung_mode(JLevel(*lv), nb, 2, 2) \
                == jpe.INTRA_FULL


@pytest.mark.parametrize("hier_mode", [0, -1, 1, 2])
def test_hier_scheduler_matches_reference(monkeypatch, hier_mode):
    """Scheduler(..., n_pods=4, n_edge=2): hier_enabled, level_acct,
    budget_for, and the knapsack's plans — level choice, bucket
    signature, chunk and tier grids, cross and intra bytes — equal."""
    from repro.configs.base import ACESyncConfig as JACE
    from repro.core.scheduler import Scheduler as JScheduler
    from repro_torch.configs.base import ACESyncConfig as TACE
    from repro_torch.core.scheduler import Scheduler as TScheduler
    _patch_constants(monkeypatch)
    sizes = [50432 * 1024, 1024, 1024, 3 * 2 ** 20, 2 ** 22, 2 ** 22,
             2 ** 20, 2 ** 20, 2 ** 20, 2 ** 20, 1024]
    js = JScheduler(JACE(hier_mode=hier_mode), sizes, 4, n_edge=2)
    ts = TScheduler(TACE(hier_mode=hier_mode), sizes, 4, n_edge=2,
                    device="cpu")
    assert (ts.n_cross, ts.n_edge, ts.acct_cross) == (js.n_cross, js.n_edge,
                                                      js.acct_cross)
    assert ts.hier_enabled == js.hier_enabled == (hier_mode >= 0)
    assert ts.level_acct == js.level_acct
    r = np.random.RandomState(3)
    omega = (0.1, 0.2, 0.3, 0.4)
    hiered = 0
    for bw in (5.0, 20.0, 50.0, 120.0, 200.0):
        assert ts.budget_for(bw) == js.budget_for(bw)
        imp = r.uniform(0.1, 2.0, size=len(sizes)).tolist()
        jp, tp = js.plan(imp, bw, omega), ts.plan(imp, bw, omega)
        for f in ("level_idx", "bucket_sig", "ring_chunks", "hier",
                  "omega", "sync_interval"):
            assert getattr(tp, f) == getattr(jp, f), (bw, f)
        assert ts.plan_wire_bytes(tp) == js.plan_wire_bytes(jp)
        assert ts.plan_intra_bytes(tp) == js.plan_intra_bytes(jp)
        hiered += any(tp.hier)
    assert (hiered > 0) == (hier_mode >= 0)


def test_cluster_policies_match_reference():
    """ClusterState on the same seeded telemetry: policies (with the
    eq-(5) kept fraction), the bottleneck bandwidth, the 2 x 2 fleet's
    slots and omega, and the snapshot, step by step."""
    from repro.configs.base import ACESyncConfig as JACE
    from repro.data.telemetry import make_profiles as jprofiles
    from repro.data.telemetry import snapshot as jsnap
    from repro.hierarchy import ClusterState as JCS
    from repro_torch.configs.base import ACESyncConfig as TACE
    from repro_torch.data.telemetry import make_profiles as tprofiles
    from repro_torch.data.telemetry import snapshot as tsnap
    from repro_torch.hierarchy import ClusterState as TCS
    jcs, tcs = JCS(16, 2), TCS(16, 2)
    jp, tp = jprofiles(16, 4), tprofiles(16, 4)
    for step in range(0, 120, 7):
        jt, tt = jsnap(jp, step), tsnap(tp, step)
        assert jt == tt
        assert tcs.update(tt) == jcs.update(jt)
        want = [dataclasses.asdict(p) for p in jcs.policies(jt, JACE())]
        got = [dataclasses.asdict(p) for p in tcs.policies(tt, TACE())]
        assert got == want
        assert tcs.bottleneck_bandwidth(tt) == jcs.bottleneck_bandwidth(jt)
        for c, e in ((2, 2), (2, 3), (4, 1)):
            assert tcs.fleet_slots(c, e) == jcs.fleet_slots(c, e)
            assert tcs.fleet_omega(tt, c, e) == jcs.fleet_omega(jt, c, e)
        assert tcs.snapshot() == jcs.snapshot()
    back = TCS(16, 2)
    back.restore_snapshot(json.loads(json.dumps(tcs.snapshot())))
    assert back.snapshot() == tcs.snapshot()


def test_acesync_hier_is_registered_and_budgets_the_bottleneck():
    """``acesync_hier`` prices its budget at the slowest cluster's
    bandwidth once clusters exist, the fleet mean before."""
    from repro_torch.hierarchy import ClusterState
    from repro_torch.strategies import build_strategy, list_strategies
    assert "acesync_hier" in list_strategies()
    st = build_strategy("acesync_hier")
    telem = [{"bandwidth_mbps": b, "latency_ms": 50.0, "straggle": 1.0}
             for b in (10.0, 12.0, 180.0, 190.0)]
    assert st.budget_bandwidth(telem, None) == pytest.approx(98.0)
    cs = ClusterState(4, 2)
    cs.update(telem)
    assert st.budget_bandwidth(telem, cs) == pytest.approx(11.0)
    assert cs.bottleneck_bandwidth(telem) == pytest.approx(11.0)


# ---------------------------------------------------------------------------
# the fleets: reference subprocesses and port pods
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import dataclasses, json, os, sys
C, E = int(sys.argv[1]), int(sys.argv[2]); OUT = sys.argv[3]
ARGS = json.loads(sys.argv[4])
F = C * E
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={F}"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as Spec
from repro import compat
from repro.codecs import build_codec
from repro.launch.mesh import make_mesh

out = {}
r = np.random.RandomState(5)
g = r.randn(F, ARGS["n_flat"]).astype(np.float32)
e = (r.randn(F, ARGS["n_flat"]) * 0.3).astype(np.float32)
om = np.arange(1, F + 1) / (F * (F + 1) / 2)
omega = jnp.asarray(om, jnp.float32)
mesh2 = make_mesh((C, E), ("pod", "edge"))
fleet = Spec(("pod", "edge"))

def hier_fn(codec, mode, k):
    def inner(gx, ex):
        pod = jax.lax.axis_index("pod")
        slot = pod * E + jax.lax.axis_index("edge")
        agg, ne = codec.ef_sync_hier(
            gx.reshape(-1), ex.reshape(-1), omega.reshape(C, E)[pod],
            omega[slot], gamma=0.9, n_cross=C, n_edge=E, intra_mode=mode,
            n_chunks=k, use_pallas=True)
        return agg[None], ne[None]
    return jax.jit(compat.shard_map(inner, mesh2, in_specs=(fleet, fleet),
                                    out_specs=(fleet, fleet),
                                    manual_axes={"pod", "edge"}))

for name, mode, k in ARGS["cases"]:
    agg, ne = hier_fn(build_codec(name), mode, k)(jnp.asarray(g),
                                                   jnp.asarray(e))
    out[f"hier/{name}/{mode}/{k}/agg"] = np.asarray(agg)
    out[f"hier/{name}/{mode}/{k}/err"] = np.asarray(ne)

if ARGS["tree"]:
    from repro.core import sync as S
    from repro.core.compression import Level
    from repro.core.planexec import build_exec_plan
    from repro.core.scheduler import SyncPlan
    mesh3 = make_mesh((C, E, 1), ("pod", "edge", "data"))
    levels = tuple(Level(*x) for x in ARGS["levels"])
    sizes = ARGS["sizes"]
    plan = SyncPlan(tuple(range(len(levels))), levels, tuple(om), 1)
    r = np.random.RandomState(11)
    gt = [r.randn(F, n).astype(np.float32) for n in sizes]
    et = [(r.randn(F, n) * 0.3).astype(np.float32) for n in sizes]
    tree = {f"p{i}": jnp.asarray(x) for i, x in enumerate(gt)}
    errs = {f"p{i}": jnp.asarray(x) for i, x in enumerate(et)}
    spec = jax.tree.map(lambda _: Spec(("pod", "edge")), tree)
    for mode in (1, 2):
        ep = build_exec_plan(plan, list(sizes), n_pods=F, n_edge=E,
                             hier=mode, ring=-1)
        out[f"tree/{mode}/hier"] = np.asarray(ep.hier)

        def inner(t, err, ep=ep):
            t = jax.tree.map(lambda x: x.reshape(x.shape[1:]), t)
            err = jax.tree.map(lambda x: x.reshape(x.shape[1:]), err)
            a, ne = S.sync_tree(t, err, ep, mesh=mesh3, shardings=None,
                                gamma=0.9, inside_manual=True,
                                use_pallas=True)
            return (jax.tree.map(lambda x: x[None], a),
                    jax.tree.map(lambda x: x[None], ne))

        fn = jax.jit(compat.shard_map(inner, mesh3, in_specs=(spec, spec),
                                      out_specs=(spec, spec),
                                      manual_axes=set(mesh3.axis_names)))
        agg, ne = fn(tree, errs)
        for kk in tree:
            out[f"tree/{mode}/agg/{kk}"] = np.asarray(agg[kk])
            out[f"tree/{mode}/err/{kk}"] = np.asarray(ne[kk])

if ARGS["train"]:
    from repro.configs import SMOKE_ARCHS
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.launch.session import TrainSession
    from repro.models.registry import build_model

    def key(path):
        return "/".join(str(getattr(q, "key", getattr(q, "name", q)))
                        for q in path)

    def dump(tag, state):
        for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
            out[f"{tag}/{key(path)}"] = np.asarray(leaf)

    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS["paper-350m"],
                                             dtype="float32"),
                    shape=ShapeConfig("session", ARGS["seq"], 2 * F,
                                      "train"),
                    lr=ARGS["lr"], warmup_steps=1, total_steps=50,
                    ckpt_every=0, ckpt_dir=ARGS["ckpt"])
    mesh3 = make_mesh((C, E, 1), ("pod", "edge", "data"))
    sess = TrainSession(build_model(run.model, run), run, mesh=mesh3,
                        strategy="acesync_hier", blocking_replans=True)
    dump("state0", sess.init())
    sess.run(ARGS["steps"][0], log_every=0)
    dump("state1", sess.state)
    sess.run(ARGS["steps"][1], log_every=0)
    dump("state2", sess.state)
    out["losses"] = np.asarray(sess.losses)
    out["synced"] = np.asarray(["divergence" in h for h in sess.history])
    out["plan/level_idx"] = np.asarray(sess.loop.plan.level_idx)
    out["plan/hier"] = np.asarray(sess.loop.plan.hier)
    out["plan/omega"] = np.asarray(sess.loop.plan.omega)
np.savez(OUT, **out)
print("REF_OK")
"""


def _run_reference(n_cross, n_edge, out_path, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_FORCE_INTERPRET="1")
    return subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(n_cross), str(n_edge),
         str(out_path), json.dumps(args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _tier_bytes(group, since):
    """(cross, intra) bytes this member received in log entries
    ``since``: the fleet's and the cross tier's against the intra's."""
    new = group.log[since:]
    cross = sum(x["bytes"] for x in new
                if x["tier"] in ("fleet", "cross") and x["op"] != "reduce")
    intra = sum(x["bytes"] for x in new if x["tier"] == "intra")
    return cross, intra


def _cluster_aggregate(group, mode, g, e):
    """The tier-1 aggregate ``ef_sync_hier`` re-encodes for the cross
    tier: the intra stage ``mode`` over the member's cluster."""
    import torch
    from repro_torch.codecs import build_codec
    from repro_torch.core.planexec import INTRA_INT8
    F, E = group.size, group.n_edge
    omega = torch.tensor(_omega(F), dtype=torch.float32)
    agg_c, _ = build_codec("int8" if mode == INTRA_INT8 else "full").ef_sync(
        torch.from_numpy(g.copy()), torch.from_numpy(e.copy()),
        omega.reshape(F // E, E)[group.rank // E], omega[group.rank],
        gamma=0.9, n_pods=E, pods=group.intra)
    return agg_c.numpy()


def _port_hier_cases(group, out):
    import torch
    from repro_torch.codecs import build_codec
    F, E = group.size, group.n_edge
    C = F // E
    g, e = _hier_inputs(F)
    omega = torch.tensor(_omega(F), dtype=torch.float32)
    c = group.rank // E
    for name, mode, k in HIER_CASES:
        agg, ne = build_codec(name).ef_sync_hier(
            torch.from_numpy(g[group.rank].copy()),
            torch.from_numpy(e[group.rank].copy()),
            omega.reshape(C, E)[c], omega[group.rank], gamma=0.9,
            n_cross=C, n_edge=E, intra_mode=mode, n_chunks=k,
            cross=group.cross, intra=group.intra)
        out[f"hier/{name}/{mode}/{k}/agg"] = agg.numpy()
        out[f"hier/{name}/{mode}/{k}/err"] = ne.numpy()
    for mode in (1, 2):
        out[f"agg_c/{mode}"] = _cluster_aggregate(group, mode, g[group.rank],
                                                  e[group.rank])


def _port_tree(group, out):
    import torch
    from repro_torch.core import planexec
    from repro_torch.core import sync as S
    from repro_torch.core.compression import Level
    from repro_torch.core.scheduler import SyncPlan
    F = group.size
    levels = tuple(Level(*x) for x in LEVELS)
    plan = SyncPlan(tuple(range(len(levels))), levels, _omega(F), 1)
    g, e = _tree_inputs(F)
    tree = {f"p{i}": torch.from_numpy(x[group.rank].copy())
            for i, x in enumerate(g)}
    errs = {f"p{i}": torch.from_numpy(x[group.rank].copy())
            for i, x in enumerate(e)}
    for mode in (1, 2):
        for ring in (-1, 2):
            ep = planexec.build_exec_plan(plan, SIZES, n_pods=F,
                                          n_edge=group.n_edge, hier=mode,
                                          ring=ring, device="cpu")
            since = len(group.log)
            agg, ne = S.sync_tree(tree, errs, ep, gamma=0.9, pods=group)
            tag = f"tree/{mode}/{ring}"
            out[f"{tag}/hier"] = ep.hier
            out[f"{tag}/chunks"] = ep.chunks
            out[f"{tag}/agg"] = {k: v.numpy() for k, v in agg.items()}
            out[f"{tag}/err"] = {k: v.numpy() for k, v in ne.items()}
            out[f"{tag}/bytes"] = _tier_bytes(group, since)
            out[f"{tag}/want"] = (
                planexec.exec_wire_bytes(ep, F, n_cross=group.n_cross),
                planexec.exec_intra_bytes(ep, group.n_edge))
        # the two-tier rungs' cluster aggregates (one leaf each), for the
        # fold bound
        for i in TWO_TIER_RUNGS:
            out[f"tree/{mode}/agg_c/p{i}"] = _cluster_aggregate(
                group, mode, g[i][group.rank], e[i][group.rank])


def _port_train(group, ref_path, out):
    import torch
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import planexec
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model
    ref = dict(np.load(ref_path))
    F = group.size
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS["paper-350m"],
                                              dtype="float32"),
                    shape=ShapeConfig("session", SEQ, 2 * F, "train"),
                    lr=LR, warmup_steps=1, total_steps=50, ckpt_every=0,
                    ckpt_dir=os.path.join(os.path.dirname(ref_path),
                                          "port_ckpt"))
    sess = TrainSession(build_model(run.model, run, device="cpu"), run,
                        strategy="acesync_hier", pods=group)
    tr = sess.trainer
    sess.state = convert.pod_state_from_reference(
        {k[len("state0/"):]: v for k, v in ref.items()
         if k.startswith("state0/")}, tr, group.rank)
    step = tr.step
    out["sync_bytes"] = []

    def logged(state, batch, plan, kind="grad_sync"):
        since = len(group.log)
        res = step(state, batch, plan, kind)
        if kind == "delta_sync":
            ep = tr.exec_plan(plan)
            out["sync_bytes"].append((
                _tier_bytes(group, since),
                planexec.exec_wire_bytes(ep, F, n_cross=group.n_cross),
                planexec.exec_intra_bytes(ep, group.n_edge), ep.hier,
                ep.seg_hier))
        return res

    tr.step = logged
    names = [T.path_str(p) for p, _ in
             T.leaves_with_path(tr.model.param_shapes())]
    out["names"] = names
    for i, n in enumerate(STEPS):
        sess.run(n, log_every=0)
        out[f"params{i + 1}"] = [x.detach().numpy().copy()
                                 for x in T.leaves(sess.state["params"])]
    out["losses"] = sess.losses
    out["kinds"] = [";".join(h["kinds"]) for h in sess.history]
    out["synced"] = ["divergence" in h for h in sess.history]
    out["plan/level_idx"] = list(sess.loop.plan.level_idx)
    out["plan/hier"] = list(sess.loop.plan.hier)
    out["plan/omega"] = list(sess.loop.plan.omega)
    out["n_edge"] = tr.n_edge


def _port_member(group, ref_path, consts, train):
    """One fleet member of the port: the ef_sync_hier cases, and on the
    2 x 2 fleet the sync_tree rounds and the training run."""
    from repro_torch.core import planexec
    for k, v in consts.items():
        setattr(planexec, k, v)
    out = {"fleet": (group.n_cross, group.n_edge),
           "slot": (group.rank // group.n_edge, group.intra.rank,
                    group.cross.rank)}
    _port_hier_cases(group, out)
    if train:
        _port_tree(group, out)
        _port_train(group, ref_path, out)
    return out


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """{(C, E): (reference npz dict, [port result per member])}: the 2 x 2
    fleet runs everything, the 2 x 3 fleet the ef_sync_hier cases; the
    reference subprocesses run while the port's members do."""
    from repro_torch.launch.mesh import spawn_pods
    tmp = tmp_path_factory.mktemp("hier")
    procs = {}
    for C, E in FLEETS:
        full = (C, E) == (2, 2)
        args = {"n_flat": N_FLAT,
                "cases": HIER_CASES if full else ONE_SHOT_CASES, "tree": full,
                "train": full, "levels": LEVELS, "sizes": SIZES,
                "seq": SEQ, "lr": LR, "steps": STEPS,
                "ckpt": str(tmp / "ckpt")}
        path = tmp / f"ref{C}x{E}.npz"
        procs[(C, E)] = (_run_reference(C, E, path, args), path)
    out = {}
    try:
        for (C, E), (proc, path) in procs.items():
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
            out[(C, E)] = (dict(np.load(path)), spawn_pods(
                _port_member, C * E, "cpu",
                args=(str(path), REF_CONSTANTS, (C, E) == (2, 2)),
                n_edge=E, init_method=f"file://{tmp / f'store{C}x{E}'}",
                threads=1, timeout=600))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("fleet", FLEETS, ids=[f"{c}x{e}" for c, e in FLEETS])
def test_sub_groups_follow_the_fleet_slots(fleets, fleet):
    """Member r = c*E + e sits at rank e of its cluster's intra group and
    rank c of its edge index's cross group."""
    _, port = fleets[fleet]
    C, E = fleet
    assert [p["slot"] for p in port] == [(r // E, r % E, r // E)
                                         for r in range(C * E)]


def _cluster_bound(aggs):
    """Per-entry 2 ulp of sum_c absmax_c(block) of the cluster aggregates
    ``aggs`` (C, n) that the cross tier re-encodes (unit weights)."""
    aggs = np.asarray(aggs, np.float64)
    pad = (-aggs.shape[1]) % 1024
    blk = np.abs(np.pad(aggs, ((0, 0), (0, pad)))).reshape(
        aggs.shape[0], -1, 1024).max(axis=2).sum(axis=0)
    bound = np.repeat(blk, 1024)[:aggs.shape[1]].astype(np.float32)
    return 2 * np.spacing(bound)


def _clusters(port, key):
    """``key`` of one member per cluster, cluster order."""
    C, E = port[0]["fleet"]
    return np.stack([port[c * E][key] for c in range(C)])


def _check_hier_case(ref, port, tag, mode):
    tol = _cluster_bound(_clusters(port, f"agg_c/{mode}"))
    for p, res in enumerate(port):
        np.testing.assert_array_equal(_bits(res[f"{tag}/err"]),
                                      _bits(ref[f"{tag}/err"][p]),
                                      err_msg=f"{tag} err member {p}")
        d = np.abs(res[f"{tag}/agg"] - ref[f"{tag}/agg"][p])
        assert np.all(d <= tol), (tag, p, float(d.max()))
        np.testing.assert_array_equal(_bits(res[f"{tag}/agg"]),
                                      _bits(port[0][f"{tag}/agg"]))


@pytest.mark.parametrize("fleet", FLEETS, ids=[f"{c}x{e}" for c, e in FLEETS])
@pytest.mark.parametrize("case", ONE_SHOT_CASES,
                         ids=[f"{c}-intra{m}" for c, m, _ in ONE_SHOT_CASES])
def test_ef_sync_hier_matches_reference(fleets, fleet, case):
    """The cross tier one-shot: every member's residual bit for bit, its
    aggregate within the bound of the module doc, and the aggregate the
    same on every member."""
    ref, port = fleets[fleet]
    name, mode, k = case
    _check_hier_case(ref, port, f"hier/{name}/{mode}/{k}", mode)


@pytest.mark.parametrize("fleet", FLEETS, ids=[f"{c}x{e}" for c, e in FLEETS])
@pytest.mark.parametrize("name", ["int8", "int4"])
def test_reference_cross_fold_contracts_unit_weights(fleets, fleet, name):
    """ROADMAP R4: re-encoding the port's two cluster aggregates, the
    reference's cross-tier aggregate is ``fma(q1, s1, round(q0 * s0))``
    bit for bit, and the port's is its kernels' ``fma(1, round(q1 * s1),
    round(q0 * s0))``; the two differ."""
    import torch
    from repro_torch.codecs import build_codec
    from repro_torch.kernels.ref import fma_f32, ftz, unpack_nibbles
    ref, port = fleets[fleet]
    codec = build_codec(name)
    for mode in (1, 2):
        tag = f"hier/{name}/{mode}/0"
        qs = []
        for agg_c in _clusters(port, f"agg_c/{mode}"):
            x = torch.from_numpy(agg_c.copy())
            payload, _, _ = codec.ef_encode(x, torch.zeros_like(x),
                                            gamma=0.0)
            q = (payload["q"].float() if name == "int8"
                 else unpack_nibbles(payload["q"]))
            qs.append((q, payload["scale"][:, None].expand_as(q)
                       .contiguous()))
        (q0, s0), (q1, s1) = qs
        p0 = ftz(q0 * s0)
        contracted = fma_f32(q1, s1, p0).reshape(-1)[:N_FLAT].numpy()
        rounded = fma_f32(torch.ones_like(q1), ftz(q1 * s1),
                          p0).reshape(-1)[:N_FLAT].numpy()
        np.testing.assert_array_equal(_bits(ref[f"{tag}/agg"][0]),
                                      _bits(contracted))
        np.testing.assert_array_equal(_bits(port[0][f"{tag}/agg"]),
                                      _bits(rounded))
        assert not np.array_equal(_bits(contracted), _bits(rounded))


@pytest.mark.parametrize("case", RING_CASES,
                         ids=[f"{c}-intra{m}" for c, m, _ in RING_CASES])
def test_ef_sync_hier_ring_cross_tier(fleets, case):
    """The cross tier as a K = 2 ring: bit-identical to the port's own
    one-shot on every member (aggregate and residual); against the
    reference's ring as the one-shot is."""
    ref, port = fleets[(2, 2)]
    name, mode, k = case
    tag, one = f"hier/{name}/{mode}/{k}", f"hier/{name}/{mode}/0"
    for res in port:
        for what in ("agg", "err"):
            np.testing.assert_array_equal(_bits(res[f"{tag}/{what}"]),
                                          _bits(res[f"{one}/{what}"]))
    _check_hier_case(ref, port, tag, mode)


@pytest.mark.parametrize("mode", [1, 2])
def test_two_tier_sync_tree_matches_reference(fleets, mode):
    """sync_tree with a two-tier plan (INT8 / INT4 two-tier with the bf16
    or INT8 intra stage; TOPK10 / SIGN1 / FULL / SKIP flat over the
    fleet), cross tier one-shot, against the reference as the module doc
    states; the K = 2 cross ring bit-identical to the one-shot on every
    member."""
    ref, port = fleets[(2, 2)]
    F = 4
    one, rng = f"tree/{mode}/-1", f"tree/{mode}/2"
    assert tuple(port[0][f"{one}/hier"]) == tuple(ref[f"tree/{mode}/hier"])
    assert port[0][f"{one}/hier"][:4] == (mode, 0, 0, mode)
    assert port[0][f"{rng}/chunks"][0] == 2
    for p, res in enumerate(port):
        for i in range(len(SIZES)):
            key = f"p{i}"
            for what in ("agg", "err"):
                got = res[f"{one}/{what}"][key]
                want = ref[f"tree/{mode}/{what}/{key}"][p]
                msg = f"mode {mode} {what} {LEVELS[i][0]} member {p}"
                if i == SIGN_RUNG:
                    blk = np.abs(ref[f"tree/{mode}/agg/{key}"][p]).max()
                    tol = SIGN_ULP * np.spacing(np.float32(blk)) \
                        + F * 2.0 ** -16
                    assert np.abs(got - want).max() <= tol, msg
                elif i in TWO_TIER_RUNGS and what == "agg":
                    tol = _cluster_bound(_clusters(
                        port, f"tree/{mode}/agg_c/{key}"))
                    assert np.all(np.abs(got - want) <= tol), msg
                else:
                    np.testing.assert_array_equal(_bits(got), _bits(want),
                                                  err_msg=msg)
                np.testing.assert_array_equal(
                    _bits(res[f"{rng}/{what}"][key]), _bits(got),
                    err_msg=msg + " (ring)")
            np.testing.assert_array_equal(
                _bits(res[f"{one}/agg"][key]),
                _bits(port[0][f"{one}/agg"][key]))


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("ring", [-1, 2])
def test_two_tier_bytes_per_tier(fleets, mode, ring):
    """Bytes logged per member: the fleet's and the cross tier's equal the
    analytic cross-tier bytes (two-tier rungs at the cluster count, FULL's
    reduce-scatter + all-gather exactly, as 4 divides its bucket), the
    intra tier's the analytic intra bytes."""
    _, port = fleets[(2, 2)]
    for res in port:
        got, want = res[f"tree/{mode}/{ring}/bytes"], \
            res[f"tree/{mode}/{ring}/want"]
        assert tuple(got) == tuple(want) and min(want) > 0, (mode, ring)


def test_acesync_hier_trains_like_reference(fleets):
    ref, port = fleets[(2, 2)]
    first = port[0]
    assert first["n_edge"] == 2
    assert ref["synced"].tolist() == first["synced"]
    assert first["kinds"].count("local;delta_sync") == 1
    assert first["plan/level_idx"] == ref["plan/level_idx"].tolist()
    assert first["plan/hier"] == ref["plan/hier"].tolist()
    assert any(first["plan/hier"]), first["plan/hier"]
    np.testing.assert_allclose(first["plan/omega"], ref["plan/omega"],
                               rtol=1e-12)
    print("losses port", first["losses"], "reference",
          ref["losses"].tolist())
    np.testing.assert_allclose(first["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    for res in port[1:]:
        assert res["losses"] == first["losses"]
        # the members hold the same parameters after the delta_sync
        for a, b in zip(first["params1"], res["params1"]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    worst = 0.0
    for i in (1, 2):
        for p, res in enumerate(port):
            for name, got in zip(first["names"], res[f"params{i}"]):
                d = float(np.abs(got - ref[f"state{i}/params/{name}"][p])
                          .max())
                assert d <= PARAM_ATOL, (i, name, p, d)
                worst = max(worst, d)
    print("largest parameter difference", worst)
    # the delta_sync's bytes per tier are its executed plan's priced bytes
    for res in port:
        (sync,) = res["sync_bytes"]
        (cross, intra), want_cross, want_intra, hier, seg_hier = sync
        assert any(hier) or any(any(h) for h in seg_hier)
        assert (cross, intra) == (want_cross, want_intra), sync
        assert intra > 0 and cross > 0
