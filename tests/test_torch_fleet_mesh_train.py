"""Pods x ("data", "model"): training, checkpoints and elastic membership
on P pods of D x M meshes, the port's gloo ranks on the CPU
(``spawn_fleet_mesh``, ``file://`` rendezvous; rank code in
``tests/torch_fleet_mesh_ranks.py``), SMOKE configs in f32 compute.

The reference's multi-pod trainer aborts on such meshes on the CPU
(ROADMAP R1), so each pod is held to the live reference's one-pod
``Trainer(mesh=make_mesh((1, 2), ("data", "model")))`` — the forward and
backward its pods compute in auto mode — run in a subprocess on the pod's
rows of each global batch, from its own initial state; the pod exchange
is held to the reference's round on the rank's shards by
tests/test_torch_fleet_mesh.py.  Checked:

* (c) paper-350m and qwen3-moe-30b-a3b on (2, 1, 2) through
  ``TrainSession`` (``sync_interval_init`` 3, ``replan_every`` 3: three
  ``local`` steps, a ``delta_sync``, a device replan, another
  ``delta_sync``): before the first sync the pod-mean losses and grad
  norms within ``LOSS_RTOL`` = 1e-5 relative of the mean of the
  reference's pods, and each pod's gathered params, m, v and error
  buffers within ``STATE_RTOL`` = 1e-4 of each leaf's norm of the
  reference's pod (tests/torch_mesh_train_ref.py's tolerances); after
  each sync every parameter shard bit-identical across the pods; the
  bytes each (d, m)'s pod group moved equal to ``plan_wire_bytes`` of
  its local layout (FULL's within its shard padding); H, the step kinds,
  the plan and omega identical on every rank.
* (d) the (2, 1, 2) checkpoint of paper-350m's state at the end: its
  leaf files byte for byte, and its shapes, dtypes and CRCs, those the
  reference's ``Checkpointer`` writes for the same stacked (P, ...)
  state; restored onto (2, 2, 1), onto 2 pods x one card and onto
  (3, 1, 2) (the reference's tile: pod p reads row p mod 2), each
  assembling (``convert.reference_from_shards`` with the pod row) to
  that state bit for bit.
* (e) elastic membership (3, 1, 2) -> (2, 1, 2) -> (3, 1, 2), pod 1
  preempted at step 4 and back at step 8, checkpoints every 5 steps
  (chip_smoke.py phase 9b's gates): the membership events, the global
  batch at 2 rows a pod, the bytes priced at the step's pod count
  (ROADMAP R6), the preempted pod idle, the survivors keeping their own
  state through the cut (R5), the rejoining pod's rank (d, m) holding
  pod 0's rank (d, m)'s state right after the rejoin, the same plan,
  omega and parameters on every live pod, the same losses on every rank,
  and the step-10 checkpoint (three pods' rows) restored as a P = 2
  fleet of meshes to the rows pods 0 and 1 wrote.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch_fleet_mesh_ranks as R

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("paper-350m", "qwen3-moe-30b-a3b")
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4
TREES = ("params", "m", "v", "ace/errors")
CKPT_ARCH = ARCHS[0]

REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.configs.base import RunConfig, ShapeConfig
from repro.core.trainer import Trainer
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model

A = json.loads(sys.argv[1])
P = A["pods"]
mesh = make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])


def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def flat(tree, tag, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{tag}/{key_of(path)}"] = np.asarray(leaf)[0]


def save(name, out):
    path = os.path.join(A["out"], name)
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)


runs = {}
for arch in A["archs"]:
    # one pod's shape: its rows of the global batch
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS[arch],
                                              dtype="float32"),
                    shape=ShapeConfig("t", A["seq"], A["batch"] // P,
                                      "train"),
                    lr=A["lr"], warmup_steps=1, total_steps=50)
    model = build_model(run.model, run)
    tr = Trainer(model, run, mesh=mesh, strategy="acesync")
    state0 = jax.device_get(tr.init_state(jax.random.PRNGKey(0)))
    out = {}
    flat(state0, "state0", out)
    save(f"{arch}_init.npz", out)
    runs[arch] = (run, model, tr, state0)

for arch, (run, model, tr, state0) in runs.items():
    out = {}
    plan = tr.default_plan()
    whole = TokenPipeline(model, ShapeConfig("t", A["seq"], A["batch"],
                                             "train"), seed=0)
    per = A["batch"] // P
    for p in range(P):
        state = jax.device_put(state0, tr.state_shardings())
        for i in range(A["steps"]):
            b = {k: v[p * per:(p + 1) * per]
                 for k, v in whole._host_batch(i).items()}
            batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                   tr.batch_shardings(run.shape))
            state, m = tr.step(state, batch, plan, "local")
            for k, v in m.items():
                out[f"pod{p}/step{i}/{k}"] = np.asarray(v)
        for t in A["trees"]:
            sub = state
            for part in t.split("/"):
                sub = sub[part] if isinstance(sub, dict) else getattr(sub,
                                                                       part)
            flat(sub, f"pod{p}/{t}", out)
    save(f"{arch}.npz", out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(the reference's one-pod runs {arch: npz}, [the port's
    ``session_rank`` per rank], the checkpoint directory): the port's
    ranks start once the reference has written every initial state."""
    from repro_torch.launch.mesh import spawn_fleet_mesh
    tmp = tmp_path_factory.mktemp("fleet_train")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    args = {"pods": 2, "archs": list(ARCHS), "seq": R.SEQ,
            "batch": R.BATCH, "lr": R.LR, "steps": R.PRE_SYNC,
            "trees": list(TREES), "out": str(tmp)}
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        inits = {a: tmp / f"{a}_init.npz" for a in ARCHS}
        deadline = time.monotonic() + 600
        while not all(p.exists() for p in inits.values()):
            if proc.poll() not in (None, 0) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        port = spawn_fleet_mesh(
            R.session_rank, 2, 1, 2, "cpu",
            args=(ARCHS, {a: str(p) for a, p in inits.items()},
                  str(tmp / "ck")),
            init_method=f"file://{tmp / 'store'}", threads=1, timeout=600)
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ref = {a: dict(np.load(tmp / f"{a}.npz")) for a in ARCHS}
    return ref, port, tmp / "ck" / CKPT_ARCH


@pytest.mark.parametrize("arch", ARCHS)
def test_each_pod_before_the_first_sync_is_the_references(sessions, arch):
    from repro_torch import convert
    ref, port, _ = sessions
    want = ref[arch]
    for r in port:
        got = r["archs"][arch]
        kinds = [s["kind"] for s in got["steps"]]
        assert kinds[:R.PRE_SYNC + 1] == ["local"] * R.PRE_SYNC + [
            "delta_sync"]
        for i in range(R.PRE_SYNC):
            for k in ("loss", "grad_norm"):
                w = np.mean([float(want[f"pod{p}/step{i}/{k}"])
                             for p in (0, 1)])
                g = got["history"][i][k]
                assert abs(g - w) <= LOSS_RTOL * abs(w), (r["pod"], i, k)
    stacked = convert.reference_from_shards(
        [r["archs"][arch]["pre"] for r in port],
        pods=[r["pod"] for r in port])
    for p in (0, 1):
        for key, whole in stacked.items():
            tree = next((t for t in TREES if key.startswith(t + "/")), None)
            if tree is None:
                continue
            w = want[f"pod{p}/{key}"]
            assert whole[p].shape == w.shape, key
            err = float(np.abs(whole[p].astype(np.float64) - w).max())
            assert err <= STATE_RTOL * float(np.linalg.norm(w)), (p, key,
                                                                    err)


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_are_the_same_on_every_pod_after_each_sync(sessions, arch):
    _, port, _ = sessions
    syncs = 0
    for r in port:
        mate = next(q for q in port if q["rank"] == r["rank"]
                    and q["pod"] == 0)
        for a, b in zip(r["archs"][arch]["steps"],
                        mate["archs"][arch]["steps"]):
            assert (a["step"], a["kind"]) == (b["step"], b["kind"])
            if "params" in a:
                syncs += 1
                assert a["params"] == b["params"], (r["pod"], a["step"])
    assert syncs == 2 * len(port)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_cells_bytes_are_plan_wire_bytes(sessions, arch):
    _, port, _ = sessions
    for r in port:
        for s in r["archs"][arch]["steps"]:
            if "bytes" not in s:
                continue
            pay_got, full_got, pay, full, pad = s["bytes"]
            assert pay_got == pay > 0
            assert full_got == full or 0 <= full_got - full < pad
            assert 0 <= pay_got + full_got - s["wire"] < max(pad, 1)
            assert s["adaptive"] or s["wire"] == s["exact"]


@pytest.mark.parametrize("arch", ARCHS)
def test_h_plan_and_omega_are_the_same_on_every_rank(sessions, arch):
    _, port, _ = sessions
    keys = ("step", "kind", "H", "P", "levels", "omega")
    first = [{k: s[k] for k in keys} for s in port[0]["archs"][arch]["steps"]]
    assert first[-1]["step"] == R.STEPS_RUN
    for r in port:
        assert r["archs"][arch]["replans"] == 1
        got = [{k: s[k] for k in keys} for s in r["archs"][arch]["steps"]]
        assert got == first, (r["pod"], r["rank"])
        assert r["archs"][arch]["losses"] == port[0]["archs"][arch]["losses"]


@pytest.fixture(scope="module")
def checkpoint(sessions, tmp_path_factory):
    """(the stacked state the (2, 1, 2) ranks saved, the reference's
    checkpoint of it, and the restores {fleet: assembled state})."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.configs.base import RunConfig as JRun, ShapeConfig as JShape
    from repro.core.trainer import Trainer as JTrainer
    from repro.models.registry import build_model as jbuild
    from repro_torch import convert
    from repro_torch.launch.mesh import spawn_fleet_mesh, spawn_pods
    _, port, ck = sessions
    tmp = tmp_path_factory.mktemp("fleet_ckpt")
    stacked = convert.reference_from_shards(
        [r["archs"][CKPT_ARCH]["saved"] for r in port],
        pods=[r["pod"] for r in port])
    import dataclasses
    jrun = JRun(model=dataclasses.replace(J_SMOKE[CKPT_ARCH],
                                          dtype="float32"),
                shape=JShape("t", R.SEQ, R.BATCH, "train"), lr=R.LR,
                warmup_steps=1, total_steps=50)
    jt = JTrainer(jbuild(jrun.model, jrun), jrun, mesh=None,
                  strategy="acesync")
    treedef = jax.tree_util.tree_structure(
        jax.eval_shape(jt.init_state, jax.random.PRNGKey(0)))
    step = R.STEPS_RUN
    JCheckpointer(str(tmp / "ref")).save(
        step, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(x) for x in stacked.values()]),
        extras={}, blocking=True)
    restores = {}
    for P, D, M in ((2, 2, 1), (3, 1, 2)):
        res = spawn_fleet_mesh(R.restore_rank, P, D, M, "cpu",
                               args=(CKPT_ARCH, str(ck)),
                               init_method=f"file://{tmp / f'st{P}{D}{M}'}",
                               threads=1, timeout=600)
        restores[(P, D, M)] = res
    restores["2 pods"] = spawn_pods(R.restore_pod, 2, "cpu",
                                    args=(CKPT_ARCH, str(ck)),
                                    init_method=f"file://{tmp / 'st_one'}",
                                    threads=1, timeout=600)
    return stacked, ck / f"step_{step:08d}", \
        tmp / "ref" / f"step_{step:08d}", restores


def test_checkpoint_files_are_the_references(checkpoint):
    stacked, port_dir, ref_dir, _ = checkpoint
    n = len(stacked)
    for i in range(n):
        a = (port_dir / f"leaf_{i}.npy").read_bytes()
        b = (ref_dir / f"leaf_{i}.npy").read_bytes()
        assert a == b, f"leaf_{i}"
    mp, mr = (json.loads((d / "manifest.json").read_text())
              for d in (port_dir, ref_dir))
    assert mp["n_leaves"] == mr["n_leaves"] == n
    assert mp["leaves"] == mr["leaves"]
    assert all(m["shape"][0] == 2 for m in mp["leaves"])


@pytest.mark.parametrize("fleet", [(2, 2, 1), "2 pods", (3, 1, 2)],
                         ids=["2x2x1", "2-pods-one-card", "3x1x2"])
def test_checkpoint_restores_onto_other_fleets(checkpoint, fleet):
    from repro_torch import convert
    stacked, _, _, restores = checkpoint
    res = restores[fleet]
    got = convert.reference_from_shards([r["shards"] for r in res],
                                        pods=[r["pod"] for r in res])
    P = 3 if fleet == (3, 1, 2) else 2
    rows = [p % 2 for p in range(P)]
    assert all(r["step"] == R.STEPS_RUN for r in res)
    for key, want in stacked.items():
        np.testing.assert_array_equal(got[key].view(np.uint8),
                                      want[rows].view(np.uint8), key)


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_fleet_mesh
    tmp = tmp_path_factory.mktemp("fleet_elastic")
    return spawn_fleet_mesh(R.elastic_rank, 3, 1, 2, "cpu",
                            args=(str(tmp / "ck"),),
                            init_method=f"file://{tmp / 'store'}",
                            threads=1, timeout=600)


def test_elastic_membership_of_mesh_ranks(elastic):
    kill, rejoin, killed = R.KILL, R.REJOIN, R.KILLED
    want = [(kill, 2, [0, 2]), (rejoin, 3, [0, 1, 2])]
    for r in elastic:
        assert r["events"] == (want[1:] if r["pod"] == killed else want)
        assert r["finite"]
        for s in r["steps"]:
            assert s["batch"] == R.ROWS * s["P"] == R.ROWS * len(s["omega"])
            if "bytes" in s:
                pay_got, full_got, pay, full, pad = s["bytes"]
                assert pay_got == pay > 0, (r["pod"], s["step"])
                assert full_got == full or 0 <= full_got - full < pad
                assert 0 <= pay_got + full_got - s["wire"] < max(pad, 1)
                assert s["adaptive"] or s["wire"] == s["exact"]
        if r["pod"] == killed:
            assert not [s for s in r["steps"] if s["P"] == 2]
    assert sorted({s["P"] for s in elastic[0]["steps"]}) == [2, 3]
    assert sum(1 for s in elastic[0]["steps"]
               if "bytes" in s and s["P"] == 2) >= 1


def test_elastic_survivors_keep_their_state_and_the_rejoin_adopts_pod0s(
        elastic):
    """R5: the survivors (pods 0 and 2) hold their own state through the
    cut; at the rejoin pod 1's rank (d, m) holds pod 0's rank (d, m)'s
    every state leaf."""
    by = {(r["pod"], r["rank"]): r for r in elastic}
    for (pod, rank), r in by.items():
        cut = [t for t in r["transfers"] if t["step"] == R.KILL]
        back = [t for t in r["transfers"] if t["step"] == R.REJOIN]
        assert len(cut) == len(back) == 1
        if pod == R.KILLED:
            assert not cut[0]["member"] and cut[0]["after"] is None
            assert back[0]["joining"] == [R.KILLED]
            assert back[0]["after"] == by[(0, rank)]["transfers"][1]["after"]
        else:
            assert cut[0]["before"] == cut[0]["after"]
    assert by[(2, 0)]["transfers"][0]["after"] != \
        by[(0, 0)]["transfers"][0]["after"]


def test_elastic_pods_agree_and_restore_as_two_pods(elastic):
    for r in elastic:
        mate = next(q for q in elastic if q["pod"] == 0
                    and q["rank"] == r["rank"])
        for s in r["steps"]:
            same = [q for q in mate["steps"] if q["step"] == s["step"]
                    and q["kind"] == s["kind"]]
            assert same, (r["pod"], s["step"])
            for key in ("omega", "levels", "P", "params"):
                assert s.get(key) == same[0].get(key), (key, r["pod"],
                                                        s["step"])
        # the pod-mean loss of every step the rank ran: pod 0's
        assert set(r["losses"]) <= set(elastic[0]["losses"])
        assert len(r["losses"]) == len(r["steps"]) - sum(
            1 for s in r["steps"] if s["kind"] == "delta_sync")
        if r["pod"] in (0, 1):
            assert r["restored"] == r["saved"][r["last"]]
        else:
            assert r["restored"] is None
