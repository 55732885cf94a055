"""The Trainer on a within-pod ("data", "model") mesh against the live
reference, on the CPU — the shared body of
``tests/test_torch_mesh_train_ref_<D>x<M>.py``, one file per mesh (each
file is one worker's critical path): SMOKE qwen3-8b, gemma2-9b,
qwen3-moe-30b-a3b and dbrx-132b in f32 compute, each from the
reference's own initial state.

The reference runs ``Trainer(mesh=make_mesh((D, M), ("data", "model")))``
on ``--xla_force_host_platform_device_count=4`` host devices in two
subprocesses; the port runs one gloo process per rank (``spawn_mesh``,
``file://`` rendezvous; the rank code is
``tests/torch_mesh_train_ranks.py``) as soon as the reference has written
its initial states, while the reference steps.  Checked:

* exactly: each rank's ``local_sizes`` against the reference's
  ``Trainer.local_sizes``, and the default plan's ``level_idx`` and
  ``bucket_sig`` against the reference's;
* the sync round on each rank's shards is the reference's nested manual
  region: seeded gradients and residuals through ``sync_tree`` under a
  plan with the groups round-robin on all 8 rungs, each rank's shards of
  the aggregate and of the new residuals bit for bit, but on the SIGN1
  rung, whose block scale ``mean|ef|`` XLA sums in another order: there
  within ``SIGN_ULP`` = 16 ulp of the block's scale (tests/test_torch_sync.py
  sees 8 on paper-350m's leaves; a 64-entry norm leaf here shows 16);
* for each step sequence of tests/test_torch_trainer.py (``KIND_SEQS``):
  every step's loss and grad norm within ``LOSS_RTOL`` = 1e-5 relative
  until the first sync (``SYNC_LOSS_RTOL`` = 1e-4 and ``SYNC_NORM_RTOL``
  = 1e-3 after one), and each rank's shards of the final params, m, v and
  error buffers: within ``STATE_RTOL`` = 1e-4 of each leaf's norm on the
  ``local`` sequence; after a sync a gradient that differs from the
  reference's in its last bits moves a block's quantisation scale and can
  flip a code, so the residuals are held to one code step (``ERR_STEPS``
  = 2.5 times the leaf's largest residual), m and v to ``MOMENT_RTOL`` =
  5e-2 of the leaf's largest entry, and the params to ``PARAM_ATOL`` =
  5e-2 (tests/test_torch_multipod.py's bound).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from torch_mesh_train_ranks import (BATCH, KIND_SEQS, LR, SEQ, SYNC_GAMMA,
                                    TREES)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-8b", "gemma2-9b", "qwen3-moe-30b-a3b", "dbrx-132b")
LOSS_RTOL = 1e-5
SYNC_LOSS_RTOL = 1e-4
SYNC_NORM_RTOL = 1e-3
STATE_RTOL = 1e-4
MOMENT_RTOL = 5e-2
ERR_STEPS = 2.5
PARAM_ATOL = 5e-2
SIGN_ULP = 16
SIGN_RUNG = 5

REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.configs.base import RunConfig, ShapeConfig
from repro.core import sync as S
from repro.core.trainer import Trainer
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model

A = json.loads(sys.argv[1])
D, M = A["mesh"]
mesh = make_mesh((D, M), ("data", "model"), devices=jax.devices()[:D * M])


def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def flat(tree, tag, out, pod=True):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[f"{tag}/{key_of(path)}"] = a[0] if pod else a


def save(name, out):
    # written whole, then renamed: the port's ranks start as soon as the
    # initial states appear
    path = os.path.join(A["out"], name)
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)


def seeded(shapes, seed, scale):
    paths = sorted(shapes)
    return {p: (np.random.RandomState(seed + k).randn(*shapes[p])
                * scale).astype(np.float32) for k, p in enumerate(paths)}


trainers = {}
for arch in A["archs"]:
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS[arch],
                                              dtype="float32"),
                    shape=ShapeConfig("t", A["seq"], A["batch"], "train"),
                    lr=A["lr"], warmup_steps=1, total_steps=50)
    model = build_model(run.model, run)
    tr = Trainer(model, run, mesh=mesh, strategy="acesync")
    plan = tr.default_plan()
    out = {"local_sizes": np.asarray(tr.local_sizes),
           "level_idx": np.asarray(plan.level_idx),
           "bucket_sig": np.asarray(plan.bucket_sig)}
    state0 = jax.device_get(tr.init_state(jax.random.PRNGKey(0)))
    flat(state0, "state0", out)
    save(f"{arch}_init.npz", out)
    trainers[arch] = (run, model, tr, plan, state0)

for arch, (run, model, tr, plan, state0) in trainers.items():
    out = {}
    pipe = TokenPipeline(model, run.shape, seed=0)
    for name, kinds in A["seqs"].items():
        state = jax.device_put(state0, tr.state_shardings())
        for i, kind in enumerate(kinds):
            b = pipe._host_batch(i)
            batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                   tr.batch_shardings(run.shape))
            state, m = tr.step(state, batch, plan, kind)
            for k, v in m.items():
                out[f"{name}/step{i}/{k}"] = np.asarray(v)
        for t in A["trees"]:
            sub = state
            for part in t.split("/"):
                sub = sub[part] if isinstance(sub, dict) else getattr(sub,
                                                                       part)
            flat(sub, f"{name}/{t}", out)
    # the sync-round oracle: seeded whole leaves, sharded like the params
    shapes = {key_of(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_flatten_with_path(tr.param_specs)[0]}
    treedef = jax.tree_util.tree_structure(tr.param_specs)
    order = [key_of(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tr.param_specs)[0]]
    rr = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.metas))], (1.0,))
    ep = tr.exec_plan(rr)
    sh = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                      tr.param_shardings,
                      is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    def tree(seed, scale):
        d = seeded(shapes, seed, scale)
        return jax.device_put(jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(d[k]) for k in order]), sh)

    cfg = run.acesync
    agg, err = jax.jit(lambda g, e, p: S.sync_tree(
        g, e, p, mesh=mesh, shardings=tr.param_shardings,
        gamma=A["gamma"], block=cfg.topk_block))(tree(1, 1.0),
                                                 tree(2, 0.3), ep)
    flat(agg, "sync/agg", out, pod=False)
    flat(err, "sync/err", out, pod=False)
    out["sync/level_idx"] = np.asarray(rr.level_idx)
    save(f"{arch}.npz", out)
print("REF_OK")
"""


def run_mesh(tmp: Path, mesh, archs=ARCHS, kernels=False) -> tuple:
    """({arch: the reference's results}, [the port's result per rank]) on
    ``mesh`` for ``archs``: two reference subprocesses, half the archs
    each, and the port's ranks, which start once the reference has
    written every initial state.  With ``kernels`` the reference's sync
    rounds go through its Pallas kernels, interpreted
    (``REPRO_FORCE_INTERPRET=1``), as the port's go through theirs: the
    top-k rungs select by the kernels' bisection (about k a block, as
    the port's K4), not by ``lax.top_k`` (exactly k), its CPU default."""
    from repro_torch.launch.mesh import spawn_mesh
    from torch_mesh_train_ranks import trainer_rank
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    if kernels:
        env["REPRO_FORCE_INTERPRET"] = "1"
    procs = []
    for half in (archs[::2], archs[1::2]):
        args = {"mesh": mesh, "archs": half, "seqs": KIND_SEQS,
                "trees": TREES, "seq": SEQ, "batch": BATCH, "lr": LR,
                "gamma": SYNC_GAMMA, "out": str(tmp)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        inits = {a: tmp / f"{a}_init.npz" for a in archs}
        deadline = time.monotonic() + 600
        while not all(p.exists() for p in inits.values()):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
        port = spawn_mesh(trainer_rank, *mesh, "cpu",
                          args=(archs, {a: str(p) for a, p in inits.items()}),
                          init_method=f"file://{tmp / 'store'}", threads=1,
                          timeout=600)
        for proc in procs:
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
        ref = {a: dict(np.load(tmp / f"{a}_init.npz"),
                       **np.load(tmp / f"{a}.npz")) for a in archs}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, port


def check_sizes_and_plan(ref, port, arch) -> None:
    want = ref[arch]
    for r in port:
        got = r["archs"][arch]
        assert got["local_sizes"] == want["local_sizes"].tolist()
        assert got["level_idx"] == want["level_idx"].tolist()
        assert got["bucket_sig"] == want["bucket_sig"].tolist()


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def check_sync_round(ref, port, arch) -> None:
    want = ref[arch]
    li = want["sync/level_idx"].tolist()
    for r in port:
        got = r["archs"][arch]
        paths = sorted(got["index"])
        for i, path in enumerate(paths):
            agg_w = want[f"sync/agg/{path}"][got["index"][path]]
            for tag in ("agg", "err"):
                w = want[f"sync/{tag}/{path}"][got["index"][path]]
                g = got["sync"][f"{tag}/{path}"]
                assert g.shape == w.shape, (tag, path)
                if li[i] != SIGN_RUNG:
                    np.testing.assert_array_equal(_bits(g), _bits(w),
                                                  err_msg=f"{tag}/{path}")
                    continue
                # the SIGN1 rung: 8 ulp of the block's scale, |agg|'s max
                blk = np.abs(agg_w).reshape(-1)
                pad = (-blk.size) % 1024
                s = np.concatenate([blk, np.zeros(pad, blk.dtype)]) \
                    .reshape(-1, 1024).max(axis=1, keepdims=True)
                tol = np.broadcast_to(SIGN_ULP * np.spacing(s),
                                      (s.shape[0], 1024)).reshape(-1)
                diff = np.abs(g - w).reshape(-1)
                assert np.all(diff <= tol[:diff.size]), (tag, path)


def check_step_kinds(ref, port, arch, seq) -> None:
    want = ref[arch]
    kinds = KIND_SEQS[seq]
    for r in port:
        got = r["archs"][arch]
        res = got["seqs"][seq]
        synced = False
        for i, (kind, m) in enumerate(zip(kinds, res["metrics"])):
            for k, rtol in (("loss", SYNC_LOSS_RTOL if synced else LOSS_RTOL),
                            ("grad_norm", SYNC_NORM_RTOL if synced
                             else LOSS_RTOL)):
                if k in m:
                    w = float(want[f"{seq}/step{i}/{k}"])
                    assert abs(m[k] - w) <= rtol * abs(w), (i, k, m[k], w)
            synced = synced or kind != "local"
        for key, g in res["state"].items():
            tree = next(t for t in TREES if key.startswith(t + "/"))
            w = want[f"{seq}/{key}"][got["index"][key[len(tree) + 1:]]]
            assert g.shape == w.shape, key
            err = float(np.abs(g.astype(np.float64) - w).max())
            big = float(np.abs(w).max())
            tol = STATE_RTOL * float(np.linalg.norm(w))
            if synced:
                tol = max(tol, {"params": PARAM_ATOL,
                                "ace/errors": ERR_STEPS * big}.get(
                                    tree, MOMENT_RTOL * big))
            assert err <= tol, (key, err, tol)
