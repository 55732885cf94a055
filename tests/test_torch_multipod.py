"""The port's multi-pod path against the live reference on a (P, 1, 1)
("pod", "data", "model") CPU mesh, at P = 2 and 3, on the paper-350m
smoke model.

The reference runs in a subprocess (XLA fixes its device count at first
use), with its Pallas kernels interpreted (``use_pallas=True`` /
``REPRO_FORCE_INTERPRET=1``), the counterpart of the port's kernels.  The
port runs as P gloo processes, one per pod (``spawn_pods``; rendezvous
through a ``file://`` store in the test's tmp_path, one thread each).
Both start from the reference's initial state (``convert``) under the
same plan, which puts the 11 parameter groups round-robin on all 8
ladder rungs, with a non-uniform omega, the one-shot exchange and two
backward segments.  The model computes in f32 in both packages (the
``dtype`` field both configs have), so that the gradients agree to f32
rounding and every rung sees the same inputs; the bf16 compute path is
held against the reference on one pod by tests/test_torch_trainer.py.

Checked, with their tolerances:

* ``sync_tree``, two rounds with the error feedback carried, per-pod
  distinct gradients: every pod's aggregate and residual bit for bit,
  with two exceptions.  SIGN1: the block scale is summed in another order
  (<= 8 ulp, as on one pod), so its aggregate and residual may differ by
  8 ulp of the scale plus, at P = 3, one fixed-point unit per pod
  (P * 2^-16).  INT8 / INT4 aggregates at P = 2: the port folds
  ``fma(w1, qs1, round(w0 * qs0))``, as the reference's kernels and its
  fold alone do; inside the jitted trainer XLA drops the ``0 +`` of the
  first fold and contracts the pair the other way round,
  ``fma(w0, qs0, round(w1 * qs1))``, so each entry may differ by one
  rounding of either product: 2 ulp of the bound sum_p w_p * absmax_p of
  its block.  (At P >= 3 these rungs fold in exact fixed point.)  The
  aggregate is bit-identical across the port's pods.
* the bytes the pod group gathered equal the analytic ``plan_wire_bytes``
  of the gather rungs (INT8/INT4/TOPK/SIGN1) of every segment.
* each step body (grad_sync, local, delta_sync, param_avg) fed the
  reference's own state from just before that step: every leaf of the
  state after it (params, AdamW moments, anchor, EF residuals, the
  importance estimator) against the reference's.  ``param_avg`` bit for
  bit; otherwise the difference of the two changes of a leaf, relative
  to the norm of the reference's change: 1e-5 for ``delta_sync``, 1e-3
  for ``grad_sync`` and ``local``, 1e-4 for the importance estimator, and
  5e-2 for grad_sync's EF residuals, where an entry that f32 rounding
  moves across a quantisation boundary or a top-k pick takes that code's
  whole step (largest seen: 3.9e-7, 1.8e-4, 2.0e-5 and 2.0e-2).  A body
  that does nothing differs by 1, and a uniform omega by 0.33 in the
  grad_sync aggregate.  Leaves the reference leaves untouched must stay
  bit for bit.
* the port's own trajectory through the six steps from the reference's
  initial state: the pod-mean losses within 1e-5 relative (3.5e-7 seen);
  after the first grad_sync, delta_sync and param_avg the parameters are
  bit-identical on every pod, after ``local`` they differ; at the end
  every parameter lies within 5e-2 of the reference's: five learning
  rates (1e-2), since gradients that differ in their last bits can change
  an int4 code or flip a SIGN1 vote along the way, and AdamW then moves
  that entry by up to ~lr per step in another direction (1.9e-2 is the
  largest difference seen).
  The divergence estimate uses other random projections than the
  reference, so only its sign (>= 0, > 0 after local steps) is held.
* the same step bodies fed the reference's state, with the chunked ring
  forced in both packages (``ring_chunks=2``), at P = 2 and 3, with the
  tolerances above.
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
SEQ = 32
LR = 1e-2
DTYPE = "float32"
KINDS = ("grad_sync", "local", "local", "delta_sync", "param_avg",
         "grad_sync")
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-2
SIGN_ULP = 8
#: per step kind: how far the change a step body makes to a state leaf
#: may lie from the reference's change, relative to the norm of the
#: reference's change; 0 = bit for bit
STEP_RTOL = {"param_avg": 0.0, "delta_sync": 1e-5, "grad_sync": 1e-3,
             "local": 1e-3}
#: the importance estimator's own AdamW step on pod-mean grad stats
ESTIMATOR_RTOL = 1e-4
#: grad_sync's EF residuals: where the gradients' f32 rounding moves an
#: entry across a quantisation boundary or a top-k pick, the residual
#: takes that code's whole step
EF_RTOL = 5e-2
#: the divergence EMA reads other random projections than the reference's
DIV_EMA = "ace/div_ema"
INT8_RUNG, INT4_RUNG, SIGN_RUNG = 1, 2, 5
PODS = (2, 3)
#: ACESyncConfig.ring_chunks of the runs: the one-shot exchange, and the
#: chunked ring forced to 2 chunks per ring-capable rung
ONE_SHOT, RING2 = -1, 2

REF_SCRIPT = r"""
import dataclasses, json, os, sys
P = int(sys.argv[1]); OUT = sys.argv[2]
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as Spec
from repro import compat
from repro.configs import SMOKE_ARCHS
from repro.configs.base import ACESyncConfig, RunConfig, ShapeConfig
from repro.core import sync as S
from repro.core.planexec import build_exec_plan
from repro.core.trainer import Trainer
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model

SEQ, LR, KINDS, DTYPE, RING = json.loads(sys.argv[3])
mesh = make_mesh((P, 1, 1), ("pod", "data", "model"))
run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS["paper-350m"],
                                         dtype=DTYPE),
                shape=ShapeConfig("t", SEQ, 2 * P, "train"), lr=LR,
                warmup_steps=1, total_steps=50,
                acesync=ACESyncConfig(ring_chunks=RING))
model = build_model(run.model, run)
tr = Trainer(model, run, mesh=mesh, strategy="acesync")
omega = tuple(float(x) for x in np.arange(1, P + 1) / (P * (P + 1) / 2))
levels = [i % 8 for i in range(len(tr.metas))]
plan = tr.scheduler.plan_from_levels(levels, omega)
out = {}

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)

# ---- sync_tree: two rounds, per-pod distinct grads, EF carried ----------
# (the one-shot run only)
shapes = [l.shape for l in jax.tree.leaves(tr.param_specs)]
treedef = jax.tree.structure(tr.param_specs)
r = np.random.RandomState(1)
g = jax.tree.unflatten(treedef, [jnp.asarray(
    r.randn(P, *s).astype(np.float32)) for s in shapes])
e = jax.tree.unflatten(treedef, [jnp.asarray(
    (r.randn(P, *s) * 0.3).astype(np.float32)) for s in shapes])
ep = build_exec_plan(plan, [m.size for m in tr.metas], n_pods=P, ring=0,
                     segments=2)

def inner(t, err):
    t = jax.tree.map(lambda x: x.reshape(x.shape[1:]), t)
    err = jax.tree.map(lambda x: x.reshape(x.shape[1:]), err)
    a, ne = S.sync_tree(t, err, ep, mesh=mesh, shardings=None, gamma=0.9,
                        inside_manual=True, use_pallas=True)
    return (jax.tree.map(lambda x: x[None], a),
            jax.tree.map(lambda x: x[None], ne))

pod = jax.tree.map(lambda _: Spec("pod"), g)
fn = jax.jit(compat.shard_map(inner, mesh, in_specs=(pod, pod),
                              out_specs=(pod, pod),
                              manual_axes=set(mesh.axis_names)))
for rnd in range(2 if RING == -1 else 0):
    gr = jax.tree.map(lambda x: x * (1.0 + 0.25 * rnd), g)
    agg, e = fn(gr, e)
    for name, tree in (("agg", agg), ("err", e)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"sync{rnd}/{name}/{key(path)}"] = np.asarray(leaf)

# ---- the four step kinds ------------------------------------------------
# the whole state before every step and after the last: state{i}/...
def dump(i, state):
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        out[f"state{i}/{key(path)}"] = np.asarray(leaf)

state = jax.device_put(tr.init_state(jax.random.PRNGKey(0)),
                       tr.state_shardings())
pipe = TokenPipeline(model, run.shape, seed=0)
for i, kind in enumerate(KINDS):
    dump(i, state)
    b = pipe._host_batch(i)
    batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                           tr.batch_shardings(run.shape))
    state, m = tr.step(state, batch, plan, kind)
    for k, v in m.items():
        out[f"step{i}/{k}"] = np.asarray(v)
dump(len(KINDS), state)
np.savez(OUT, **out)
print("REF_OK")
"""


def _flat(obj, prefix=""):
    """A port state as {reference key: numpy array} (dict keys and
    NamedTuple fields joined with "/", as ``convert`` reads them)."""
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    else:
        return {prefix: obj.detach().numpy().copy()}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_sync_rounds(group, tr, plan, levels, n_pods, out):
    """The port's two sync_tree rounds and its byte log (into ``out``)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.codecs import plan_wire_bytes
    from repro_torch.core import planexec
    from repro_torch.core import sync as S

    rank = group.rank
    shapes = tr.model.param_shapes()
    names = [T.path_str(p) for p, _ in T.leaves_with_path(shapes)]
    g, e = _inputs(n_pods, T.leaves(shapes))
    g, e = [x[rank] for x in g], [x[rank] for x in e]
    treedef = T.flatten(shapes)[1]
    e = T.unflatten(treedef, [torch.from_numpy(x) for x in e])
    ep = planexec.build_exec_plan(plan, tr.sizes, n_pods=n_pods, ring=-1,
                                  segments=2, device="cpu")
    group.log.clear()
    for rnd in range(2):
        gr = T.unflatten(treedef, [torch.from_numpy(x * (1.0 + 0.25 * rnd))
                                   for x in g])
        agg, e = S.sync_tree(gr, e, ep, gamma=0.9, pods=group)
        for name, tree in (("agg", agg), ("err", e)):
            for n, leaf in zip(names, T.leaves(tree)):
                out[f"sync{rnd}/{name}/{n}"] = leaf.numpy()
    gather_rungs = [i for i, lv in enumerate(plan.levels)
                    if lv.codec.supports_ring]
    out["bytes/logged"] = group.bytes_logged("gather")
    out["bytes/gathers"] = sum(1 for x in group.log if x["op"] == "gather")
    # analytic: plan_wire_bytes of the gather rungs of every segment
    # (exact bucket sizes, so the segments add up to the whole plan)
    only = type(plan)(tuple(levels), plan.levels, plan.omega, 1)
    only.level_idx = tuple(li if li in gather_rungs else 7
                           for li in levels)             # 7 = SKIP
    out["bytes/analytic"] = 2 * plan_wire_bytes(only, tr.sizes, n_pods)


def _port_pod(group, ref_path, n_pods, ring_chunks):
    """One pod of the port: the same sync rounds and step kinds (the ring
    run: the step bodies fed the reference's state only)."""
    import torch
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model

    ref = dict(np.load(ref_path))
    rank = group.rank
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS["paper-350m"],
                                              dtype=DTYPE),
                    shape=ShapeConfig("t", SEQ, 2 * n_pods, "train"),
                    lr=LR, warmup_steps=1, total_steps=50,
                    acesync=ACESyncConfig(ring_chunks=ring_chunks))
    tr = Trainer(build_model(run.model, run, device="cpu"), run,
                 strategy="acesync", pods=group)
    omega = tuple(float(x) for x in
                  np.arange(1, n_pods + 1) / (n_pods * (n_pods + 1) / 2))
    levels = [i % 8 for i in range(len(tr.metas))]
    plan = tr.scheduler.plan_from_levels(levels, omega)
    out = {}

    # ---- sync_tree (the one-shot run) --------------------------------
    if ring_chunks == ONE_SHOT:
        _port_sync_rounds(group, tr, plan, levels, n_pods, out)

    # ---- the four step kinds ------------------------------------------
    def leaves(tree):
        return [x.detach().numpy().copy() for x in T.leaves(tree)]

    def ref_state(i):
        tag = f"state{i}/"
        return convert.pod_state_from_reference(
            {k[len(tag):]: v for k, v in ref.items() if k.startswith(tag)},
            tr, rank)

    pipe = TokenPipeline(tr.model, run.shape, seed=0, pod=rank,
                         n_pods=n_pods)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.host_batch(i).items()}
               for i in range(len(KINDS))]
    # the port's own trajectory from the reference's initial state
    state = ref_state(0)
    for i, kind in enumerate(KINDS if ring_chunks == ONE_SHOT else ()):
        state, m = tr.step(state, batches[i], plan, kind)
        for k, v in m.items():
            out[f"step{i}/{k}"] = float(v)
        out[f"params{i}"] = leaves(state["params"])
    # every step body once more, fed the reference's state from just
    # before that step; the whole state after it, keyed as the reference's
    for i, kind in enumerate(KINDS):
        state, _ = tr.step(ref_state(i), batches[i], plan, kind)
        out[f"fed{i}"] = _flat(state)
    ep = tr.exec_plan(plan)
    out["chunks"] = [list(c) for c in ep.seg_chunks or (ep.chunks,)]
    out["final_names"] = [T.path_str(p) for p, _ in
                          T.leaves_with_path(tr.model.param_shapes())]
    return out


def _run_reference(n_pods, out_path, ring_chunks):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_FORCE_INTERPRET="1")
    return subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             str(n_pods), str(out_path),
                             json.dumps([SEQ, LR, KINDS, DTYPE,
                                         ring_chunks])], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """{(P, ring_chunks): (reference npz dict, [port result per pod])} for
    P = 2, 3 under the one-shot exchange and the forced 2-chunk ring: the
    reference subprocesses run while the port's pods do."""
    from repro_torch.launch.mesh import spawn_pods
    tmp = tmp_path_factory.mktemp("multipod")
    keys = [(P, ring) for ring in (ONE_SHOT, RING2) for P in PODS]
    refs = {}
    for P, ring in keys:
        path = tmp / f"ref{P}_{ring}.npz"
        refs[(P, ring)] = (_run_reference(P, path, ring), path)
    out = {}
    try:
        for key in keys:
            P, ring = key
            proc, path = refs[key]
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
            store = tmp / f"store{P}_{ring}"
            port = spawn_pods(_port_pod, P, "cpu", args=(str(path), P, ring),
                              init_method=f"file://{store}", threads=1,
                              timeout=600)
            out[key] = (dict(np.load(path)), port)
    finally:
        for proc, _ in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.fixture(scope="module")
def runs(all_runs):
    """{P: (reference, port)} under the one-shot exchange."""
    return {P: all_runs[(P, ONE_SHOT)] for P in PODS}


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _inputs(n_pods, shapes):
    """The per-pod grads and initial residuals both packages were fed."""
    r = np.random.RandomState(1)
    g = [r.randn(n_pods, *s).astype(np.float32) for s in shapes]
    e = [(r.randn(n_pods, *s) * 0.3).astype(np.float32) for s in shapes]
    return g, e


def _fold_bound(ef, omega):
    """Per-entry bound sum_p w_p * absmax_p(block) of a float fold of
    absmax-quantised payloads; ``ef`` (P, ...) the encoded values."""
    flat = ef.reshape(ef.shape[0], -1).astype(np.float64)
    pad = (-flat.shape[1]) % 1024
    blk = np.abs(np.pad(flat, ((0, 0), (0, pad)))).reshape(
        ef.shape[0], -1, 1024).max(axis=2)
    bound = (np.asarray(omega)[:, None] * blk).sum(axis=0)
    return np.repeat(bound, 1024)[:flat.shape[1]].reshape(ef.shape[1:])


@pytest.mark.parametrize("n_pods", PODS)
def test_sync_tree_matches_live_reference(runs, n_pods):
    ref, port = runs[n_pods]
    names = port[0]["final_names"]
    levels = [i % 8 for i in range(len(names))]
    shapes = [ref[f"sync0/agg/{n}"].shape[1:] for n in names]
    g, e0 = _inputs(n_pods, shapes)
    omega = np.arange(1, n_pods + 1) / (n_pods * (n_pods + 1) / 2)
    for rnd in range(2):
        for what in ("agg", "err"):
            for gi, name in enumerate(names):
                want = ref[f"sync{rnd}/{what}/{name}"]
                e_in = e0[gi] if rnd == 0 else ref[f"sync0/err/{name}"]
                ef = g[gi] * (1.0 + 0.25 * rnd) + 0.9 * e_in
                for p in range(n_pods):
                    got = port[p][f"sync{rnd}/{what}/{name}"]
                    w = want[p]
                    msg = f"round {rnd} {what} {name} pod {p}"
                    if (levels[gi] in (INT8_RUNG, INT4_RUNG)
                            and what == "agg" and n_pods == 2):
                        tol = 2 * np.spacing(
                            _fold_bound(ef, omega).astype(np.float32))
                        assert np.all(np.abs(got - w) <= tol), msg
                    elif levels[gi] == SIGN_RUNG:
                        blk = np.abs(ref[f"sync{rnd}/agg/{name}"][p])
                        tol = (SIGN_ULP * np.spacing(blk.max())
                               + (n_pods * 2.0 ** -16 if n_pods >= 3
                                  else 0.0))
                        assert np.abs(got - w).max() <= tol, msg
                    else:
                        np.testing.assert_array_equal(_bits(got), _bits(w),
                                                      err_msg=msg)
            # the aggregate is the same on every pod of the port
            for name in names:
                a0 = port[0][f"sync{rnd}/agg/{name}"]
                for p in range(1, n_pods):
                    np.testing.assert_array_equal(
                        _bits(port[p][f"sync{rnd}/agg/{name}"]), _bits(a0))


@pytest.mark.parametrize("n_pods", PODS)
def test_gathered_bytes_equal_plan_wire_bytes(runs, n_pods):
    """The reference's contract "analytic wire bytes equal the bytes
    sent": the pod group's byte log over two sync rounds is twice the
    plan's wire bytes on its gather rungs, moved in one all_gather per
    backward segment and round."""
    _, port = runs[n_pods]
    for p in range(n_pods):
        assert port[p]["bytes/logged"] == port[p]["bytes/analytic"] > 0
        assert port[p]["bytes/gathers"] == 2 * 2


@pytest.mark.parametrize("n_pods", PODS)
def test_step_kinds_match_live_reference(runs, n_pods):
    ref, port = runs[n_pods]
    with_loss = [i for i, k in enumerate(KINDS)
                 if k in ("grad_sync", "local")]
    tl = [port[0][f"step{i}/loss"] for i in with_loss]
    jl = [float(ref[f"step{i}/loss"]) for i in with_loss]
    print(n_pods, "losses port", tl, "reference", jl)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for p in range(1, n_pods):        # pod-mean metrics agree on all pods
        for i, k in enumerate(KINDS):
            for m in ("loss", "divergence"):
                key = f"step{i}/{m}"
                if key in port[0]:
                    assert port[p][key] == port[0][key], (key, p)
    for i in range(len(KINDS)):
        if f"step{i}/divergence" in port[0]:
            assert port[0][f"step{i}/divergence"] >= 0.0
    # the delta_sync after two local steps saw diverged pods
    assert port[0][f"step{KINDS.index('delta_sync')}/divergence"] > 0.0
    names = port[0]["final_names"]
    # pods hold the same parameters after a sync from a shared state, and
    # not after local steps; the last grad_sync applies the same aggregate
    # through AdamW moments that the local steps made differ, so there the
    # pods differ (in the reference too)
    expect = (True, False, False, True, True, False)
    for i, kind in enumerate(KINDS):
        same = all(np.array_equal(_bits(a), _bits(b))
                   for p in range(1, n_pods)
                   for a, b in zip(port[0][f"params{i}"],
                                   port[p][f"params{i}"]))
        assert same == expect[i], (i, kind)
    final = f"state{len(KINDS)}/params"
    assert not all(np.array_equal(ref[f"{final}/{n}"][0],
                                  ref[f"{final}/{n}"][1]) for n in names)
    worst = 0.0
    for p in range(n_pods):
        for name, got in zip(names, port[p][f"params{len(KINDS) - 1}"]):
            d = np.abs(got - ref[f"{final}/{name}"][p]).max()
            assert d <= PARAM_ATOL, (name, p, d)
            worst = max(worst, float(d))
    print(n_pods, "largest final parameter difference", worst)


def _step_rtol(kind, key):
    if kind == "param_avg":
        return 0.0
    if key.startswith(("ace/importance/", "ace/mse_ema")):
        return ESTIMATOR_RTOL
    if key.startswith("ace/errors/") and kind == "grad_sync":
        return EF_RTOL
    return STEP_RTOL[kind]


def _check_fed_step_bodies(ref, port, n_pods):
    worst = {}
    for i, kind in enumerate(KINDS):
        for p in range(n_pods):
            got_all = port[p][f"fed{i}"]
            keys = {k[len(f"state{i}/"):] for k in ref
                    if k.startswith(f"state{i}/")} - {DIV_EMA}
            assert keys <= set(got_all), sorted(keys - set(got_all))
            for key in sorted(keys):
                pre = ref[f"state{i}/{key}"][p]
                want = ref[f"state{i + 1}/{key}"][p]
                got = got_all[key]
                msg = f"step {i} {kind} pod {p} {key}"
                tol = _step_rtol(kind, key)
                if (np.array_equal(pre, want) or want.dtype.kind != "f"
                        or tol == 0.0):
                    np.testing.assert_array_equal(_bits(got), _bits(want),
                                                  err_msg=msg)
                    continue
                rel = (np.linalg.norm((got - want).ravel())
                       / np.linalg.norm((want - pre).ravel()))
                assert rel <= tol, (msg, rel, tol)
                fam = (kind, key.split("/")[0 if key[:4] != "ace/" else 1])
                worst[fam] = max(worst.get(fam, 0.0), float(rel))
    print(n_pods, "worst relative difference of a leaf's change", worst)
    # the bodies that exchange moved something, so a no-op would not pass
    for kind in ("grad_sync", "delta_sync", "param_avg"):
        i = KINDS.index(kind)
        moved = [n for n in port[0]["final_names"]
                 if not np.array_equal(ref[f"state{i}/params/{n}"],
                                       ref[f"state{i + 1}/params/{n}"])
                 or not np.array_equal(ref[f"state{i}/m/{n}"],
                                       ref[f"state{i + 1}/m/{n}"])]
        assert moved, kind


@pytest.mark.parametrize("n_pods", PODS)
def test_step_bodies_match_reference_from_its_state(runs, n_pods):
    """Each step body, fed the reference's state from just before that
    step, moves every state leaf as the reference's body does."""
    _check_fed_step_bodies(*runs[n_pods], n_pods)


@pytest.mark.parametrize("n_pods", PODS)
def test_ring_step_bodies_match_reference_from_its_state(all_runs, n_pods):
    """The same with the chunked ring forced (``ring_chunks=2``) in both
    packages: every ring-capable rung of the sync steps goes round the
    ring.  At P = 2 the reference's ring folds each pod's own payload
    first (ROADMAP R3), the port's in pod order; the relative tolerances
    above hold all the same."""
    ref, port = all_runs[(n_pods, RING2)]
    assert all(any(c) for c in port[0]["chunks"]), port[0]["chunks"]
    _check_fed_step_bodies(ref, port, n_pods)


def test_default_config_rings_on_more_than_one_pod():
    """The default ACESyncConfig (ring_chunks 0 = the roofline's grid)
    rings a rung big enough for it on more than one pod, and on no pod
    count does -1 (the one-shot exchange) or a single pod ring."""
    from repro_torch.configs.base import ACESyncConfig
    from repro_torch.core import planexec
    from repro_torch.core.compression import Level
    levels = (Level("INT8", 1.0, 8), Level("FULL", 1.0, 16))
    sizes = (443_697 * 1024, 4096)            # paper-350m's whole model
    ring = planexec.ring_override(ACESyncConfig().ring_chunks)
    assert ring is None
    for P in (2, 3, 4):
        sig, chunks, hier = planexec.exec_grid((0, 1), sizes, levels, P,
                                               ring=ring)
        assert chunks[0] >= 2 and chunks[1] == 0 and sig[0] % chunks[0] == 0
        assert hier == (0, 0)
        assert planexec.exec_grid((0, 1), sizes, levels, P,
                                  ring=-1)[1] == (0, 0)
    assert planexec.exec_grid((0, 1), sizes, levels, 1, ring=ring)[1] \
        == (0, 0)


def test_backend_follows_the_layout(monkeypatch):
    """NCCL only when every pod has a card of its own; pods that share a
    card, or run on the CPU, get gloo — decided before any collective."""
    import torch
    from repro_torch.launch import mesh
    assert mesh.backend_for(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.backend_for(1, "cuda") == "nccl"
    assert mesh.backend_for(2, "cuda") == "gloo"
    assert [mesh.pod_device(r, 3, "cuda").index for r in range(3)] \
        == [0, 0, 0]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.backend_for(4, "cuda") == "nccl"
    assert [mesh.pod_device(r, 4, "cuda").index for r in range(4)] \
        == [0, 1, 2, 3]


@pytest.mark.parametrize("n_pods", PODS)
def test_pipeline_splits_the_global_batch(n_pods):
    """Pod p takes rows [p*B/P, (p+1)*B/P) of the global batch, as the
    reference's ("pod", "data") batch sharding gives them."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model
    run = RunConfig(model=SMOKE_ARCHS["paper-350m"],
                    shape=ShapeConfig("t", SEQ, 2 * n_pods, "train"))
    model = build_model(run.model, run, device="cpu")
    whole = TokenPipeline(model, run.shape, seed=3).host_batch(5)
    for p in range(n_pods):
        part = TokenPipeline(model, run.shape, seed=3, pod=p,
                             n_pods=n_pods).host_batch(5)
        for k in whole:
            np.testing.assert_array_equal(part[k],
                                          whole[k][2 * p:2 * (p + 1)])
    with pytest.raises(ValueError):
        TokenPipeline(model, ShapeConfig("t", SEQ, 5, "train"), pod=0,
                      n_pods=2)


def test_cli_trains_two_pods_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --pods 2`` spawns one process
    per pod; the pods report the same pod-mean losses and bytes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--pods", "2",
         "--smoke", "--device", "cpu", "--seq-len", str(SEQ), "--batch",
         "4", "--steps", "5", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = res["pods"]
    assert a["steps"] == b["steps"] == 5
    assert a["last_loss"] == b["last_loss"] and np.isfinite(a["last_loss"])
    assert a["wire_bytes"] == b["wire_bytes"] > 0


#: element counts of the FULL exchange checks: divisible by 2 and 4 but
#: not 3, by all three, and by none (odd)
FULL_SIZES = (4096, 3 * 1024, 1001)


def _full_contribs(n_pods, n):
    """Per-pod bf16 contributions (as f32 values), with denormal and
    signed-zero entries."""
    import torch
    r = np.random.RandomState(n)
    x = (r.randn(n_pods, n) * np.exp(r.randn(n_pods, 1) * 3)).astype(
        np.float32)
    x[:, ::7] *= 1e-39
    x[:, 1::11] = -0.0
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _full_pod(group):
    """One pod: ``full_exchange`` of every FULL_SIZES vector (one of them
    2-D), with the bytes it logged."""
    import torch
    out = {}
    for n in FULL_SIZES:
        c = torch.from_numpy(_full_contribs(group.size, n)[group.rank])
        if n == 4096:
            c = c.reshape(4, 1024)
        since = len(group.log)
        got = group.full_exchange(c.to(torch.bfloat16))
        out[n] = (got.numpy(), [(x["op"], x["tier"], x["bytes"])
                                for x in group.log[since:]])
    return out


@pytest.mark.parametrize("n_pods", (2, 3, 4))
def test_full_exchange_is_a_reduce_scatter_at_the_priced_bytes(tmp_path,
                                                              n_pods):
    """FULL's exchange (a reduce-scatter and an all-gather): on every pod
    the bits of a plain pod-order f32 sum, denormals flushed, rounded
    once to bf16; two log entries "full"; the bytes received
    4 (P-1) ceil(n/P), which is ``FullCodec.wire_bytes`` plus less than
    4 (P-1) bytes of shard padding, and exactly it where P divides n."""
    import torch
    from repro_torch.codecs import build_codec
    from repro_torch.launch.mesh import spawn_pods
    pods = spawn_pods(_full_pod, n_pods, "cpu",
                      init_method=f"file://{tmp_path / 'store'}", threads=1,
                      timeout=300)
    tiny = np.float32(np.finfo(np.float32).tiny)
    full = build_codec("full")
    for n in FULL_SIZES:
        parts = _full_contribs(n_pods, n)
        acc = parts[0].copy()
        for p in range(1, n_pods):
            acc = acc + parts[p]
            acc = np.where(np.abs(acc) < tiny, acc * np.float32(0), acc)
        want = torch.from_numpy(acc).to(torch.bfloat16).float().numpy()
        priced = full.wire_bytes(n, n_pods)
        for p, res in enumerate(pods):
            got, log = res[n]
            np.testing.assert_array_equal(_bits(got.reshape(-1)),
                                          _bits(want), err_msg=f"{n} {p}")
            assert [x[:2] for x in log] == [("full", "fleet")] * 2
            moved = sum(x[2] for x in log)
            assert moved == 4 * (n_pods - 1) * -(-n // n_pods)
            assert priced <= moved < priced + 4 * (n_pods - 1)
            assert (moved == priced) == (n % n_pods == 0), (n, moved)
