"""Parity of the port's control plane with the JAX reference: parameter
groups, the scheduler's plans, the host knapsack and the device solver,
exec-plan lowering (signatures and gather perms), the importance
estimator, telemetry and the data pipeline — on the paper-350m smoke and
full configs, fed the same seeded numpy inputs.

Tolerances: plans, signatures, perms, group metas, telemetry and batches
are identical.  Importance scores (a few small f32 matmuls, whose
reduction order differs between XLA and PyTorch) agree to 1e-6 absolute;
the plans the device solver derives from the same scores are identical.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, SMOKE_ARCHS as J_SMOKE
from repro.configs.base import ACESyncConfig as JACE
from repro.core import importance as jimp
from repro.core import knapsack as jks
from repro.core import planexec as jpe
from repro.core import sync as jsync
from repro.core.scheduler import Scheduler as JScheduler
from repro.data import telemetry as jtel
from repro.data.pipeline import TokenPipeline as JPipe
from repro.models.registry import build_model as jbuild
from repro_torch import tree as T
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.configs.base import ACESyncConfig, ShapeConfig
from repro_torch.core import importance as timp
from repro_torch.core import knapsack as tks
from repro_torch.core import planexec as tpe
from repro_torch.core import sync as tsync
from repro_torch.core.scheduler import Scheduler as TScheduler
from repro_torch.data import telemetry as ttel
from repro_torch.data.pipeline import TokenPipeline as TPipe
from repro_torch.models.registry import build_model as tbuild


def _tsched(sizes):
    return TScheduler(ACESyncConfig(), sizes, 1, device="cpu")


def _shapes(smoke):
    cfg = (SMOKE_ARCHS if smoke else ARCHS)["paper-350m"]
    jcfg = (J_SMOKE if smoke else J_ARCHS)["paper-350m"]
    jspecs = jbuild(jcfg).param_specs()
    tshapes = tbuild(cfg, device="cpu").param_shapes() if smoke else \
        jax.tree.map(lambda s: tuple(s.shape), jspecs)
    return jspecs, tshapes


@pytest.mark.parametrize("smoke", [True, False])
def test_group_metas_match(smoke):
    jspecs, tshapes = _shapes(smoke)
    jm, tm = jsync.group_metas(jspecs), tsync.group_metas(tshapes)
    assert [(m.name, m.size, m.depth, m.kind) for m in jm] == \
        [(m.name, m.size, m.depth, m.kind) for m in tm]
    if not smoke:
        assert len(tm) == 11
        assert sum(m.size for m in tm) == 454_345_728
        assert tpe.leaf_layout([m.size for m in tm]).total_blocks == 443_697


def test_smoke_model_param_tree_matches_reference_specs():
    jspecs, _ = _shapes(True)
    model = tbuild(SMOKE_ARCHS["paper-350m"], device="cpu")
    want = [(tuple(str(getattr(k, "key", k)) for k in p), tuple(s.shape))
            for p, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]]
    got = [(p, tuple(x.shape))
           for p, x in T.leaves_with_path(model.param_tree())]
    assert got == want


def _sizes(smoke):
    return [m.size for m in tsync.group_metas(_shapes(smoke)[1])]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("bw", [5.0, 20.0, 50.0, 200.0])
def test_scheduler_plan_identical(smoke, bw):
    sizes = _sizes(smoke)
    r = np.random.RandomState(int(bw))
    imp = r.rand(len(sizes)).tolist()
    jp = JScheduler(JACE(), sizes, 1).plan(imp, bw, (1.0,))
    tp = _tsched(sizes).plan(imp, bw, (1.0,))
    assert tp.level_idx == jp.level_idx
    assert tp.bucket_sig == jp.bucket_sig
    assert tp.seg_sig == jp.seg_sig
    assert tuple(tp.omega) == tuple(jp.omega)
    assert _tsched(sizes).plan_wire_bytes(tp) == \
        JScheduler(JACE(), sizes, 1).plan_wire_bytes(jp)


@pytest.mark.parametrize("seed", range(6))
def test_knapsack_solve_identical(seed):
    r = np.random.RandomState(seed)
    G = r.randint(3, 30)
    sizes = r.randint(1, 3_000_000, size=G).tolist()
    imp = r.rand(G).tolist()
    jl = JScheduler(JACE(), sizes, 1).levels
    tl = _tsched(sizes).levels
    full = sum(l.wire_bytes(n, 2) for l in jl[:1] for n in sizes)
    budget = float(r.uniform(0.02, 1.0) * full)
    assert tks.solve(imp, sizes, tl, budget, 2) == \
        jks.solve(imp, sizes, jl, budget, 2)


@pytest.mark.parametrize("seed", range(4))
def test_device_solver_identical(seed):
    sizes = _sizes(True)
    r = np.random.RandomState(seed)
    imp = r.rand(len(sizes)).astype(np.float32)
    js, ts = JScheduler(JACE(), sizes, 1), _tsched(sizes)
    for bw in (5.0, 30.0, 120.0):
        budget = js.budget_for(bw)
        want = np.asarray(jax.jit(js.device_solver())(
            jnp.asarray(imp), jnp.float32(budget)))
        got = ts.device_solver()(torch.from_numpy(imp),
                                 torch.tensor(budget, dtype=torch.float32))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _round_robin(n_groups, n_levels=8):
    return [i % n_levels for i in range(n_groups)]


@pytest.mark.parametrize("segments", [1, 2])
@pytest.mark.parametrize("growth", [None, 1.125])
@pytest.mark.parametrize("smoke", [True, False])
def test_build_exec_plan_identical(smoke, growth, segments):
    sizes = _sizes(smoke)
    for li in (_round_robin(len(sizes)),
               np.random.RandomState(1).randint(0, 8, len(sizes)).tolist()):
        jplan = JScheduler(JACE(), sizes, 1).plan_from_levels(li, (1.0,))
        tplan = _tsched(sizes).plan_from_levels(
            li, (1.0,))
        je = jpe.build_exec_plan(jplan, sizes, growth=growth,
                                 segments=segments)
        te = tpe.build_exec_plan(tplan, sizes, growth=growth,
                                 segments=segments, device="cpu")
        assert te.static_key() == je.static_key()
        jperms = jax.tree_util.tree_leaves(je.perms)
        tperms = [p for p in (te.perms if not te.segmented else
                              [q for seg in te.perms for q in seg])]
        assert len(jperms) == len(tperms)
        for a, b in zip(tperms, jperms):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tpe.exec_wire_bytes(te, 2) == jpe.exec_wire_bytes(je, 2)


def _imp_state(seed, G, hidden=32):
    """A non-trivial estimator state, as numpy."""
    r = np.random.RandomState(seed)
    p = {"w1": r.randn(1), "w2": r.randn(1), "b_temp": r.randn(1),
         "wq": r.randn(4, hidden) * 0.3, "wk": r.randn(6, hidden) * 0.3,
         "wv": r.randn(6, hidden) * 0.3, "w_out": r.randn(hidden, 1) * 0.2,
         "b_out": r.randn(1)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    m = {k: (r.randn(*v.shape) * 1e-3).astype(np.float32)
         for k, v in p.items()}
    v = {k: (r.rand(*x.shape) * 1e-4).astype(np.float32)
         for k, x in p.items()}
    return (p, m, v, r.rand(G, 2).astype(np.float32),
            r.rand(G).astype(np.float32), np.int32(seed + 3))


def _as_states(np_state):
    p, m, v, fe, nm, st = np_state
    js = jimp.ImportanceState(
        params={k: jnp.asarray(x) for k, x in p.items()},
        opt_m={k: jnp.asarray(x) for k, x in m.items()},
        opt_v={k: jnp.asarray(x) for k, x in v.items()},
        feat_ema=jnp.asarray(fe), norm_mom=jnp.asarray(nm),
        step=jnp.asarray(st))
    ts = timp.ImportanceState(
        params={k: torch.from_numpy(x) for k, x in p.items()},
        opt_m={k: torch.from_numpy(x) for k, x in m.items()},
        opt_v={k: torch.from_numpy(x) for k, x in v.items()},
        feat_ema=torch.from_numpy(fe), norm_mom=torch.from_numpy(nm),
        step=torch.tensor(st))
    return js, ts


@pytest.mark.parametrize("seed", range(3))
def test_importance_scores_and_train_step(seed):
    metas = tsync.group_metas(_shapes(True)[1])
    rows = [{"depth": m.depth, "size": m.size, "kind": m.kind}
            for m in metas]
    jsf = jimp.structural_features(rows)
    tsf = timp.structural_features(rows, device="cpu")
    np.testing.assert_array_equal(tsf.numpy(), np.asarray(jsf))
    js, ts = _as_states(_imp_state(seed, len(metas)))
    jt = jax.jit(jimp.temporal_features)(js)
    tt = timp.temporal_features(ts)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    want = np.asarray(jax.jit(lambda s, f: jimp.scores(
        s.params, jimp.temporal_features(s), f, 0.5))(js, jsf))
    got = timp.scores(ts.params, tt, tsf, 0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    target = np.random.RandomState(seed).rand(len(metas)).astype(np.float32)
    jn, jmse = jax.jit(lambda s, f, t: jimp.train_step(
        s, f, t, alpha=0.5, lr=1e-3))(js, jsf, jnp.asarray(target))
    tn, tmse = timp.train_step(ts, tsf, torch.from_numpy(target), alpha=0.5,
                               lr=1e-3)
    np.testing.assert_allclose(float(tmse), float(jmse), rtol=1e-5)
    for k in tn.params:
        np.testing.assert_allclose(tn.params[k].numpy(),
                                   np.asarray(jn.params[k]), atol=1e-6)
    # the device solver turns equal scores into the identical plan
    sizes = [m.size for m in metas]
    budget = JScheduler(JACE(), sizes, 1).budget_for(30.0)
    a = _tsched(sizes).device_solver()(
        torch.from_numpy(np.array(want)), torch.tensor(budget))
    b = jax.jit(JScheduler(JACE(), sizes, 1).device_solver())(
        jnp.asarray(want), jnp.float32(budget))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_telemetry_identical():
    jp, tp = jtel.make_profiles(8, 3), ttel.make_profiles(8, 3)
    for step in (0, 4, 17):
        assert ttel.snapshot(tp, step, 3) == jtel.snapshot(jp, step, 3)


def test_pipeline_batches_identical():
    shape_t = ShapeConfig("t", 48, 3, "train")
    jshape = __import__("repro.configs.base", fromlist=["ShapeConfig"]) \
        .ShapeConfig("t", 48, 3, "train")
    jm = jbuild(J_SMOKE["paper-350m"])
    tm = tbuild(SMOKE_ARCHS["paper-350m"], device="cpu")
    jpipe, tpipe = JPipe(jm, jshape, seed=5), TPipe(tm, shape_t, seed=5)
    for _ in range(2):
        jb, tb = next(jpipe), next(tpipe)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
