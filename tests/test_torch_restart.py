"""The port's fault-tolerant train loop on the CPU, on the paper-350m
smoke model (seq 32): restart-replay, elastic membership against the live
reference, and the train CLI's resume.

* Restart-replay, at one pod and at P = 2 (gloo pod processes): run A
  trains 10 steps uninterrupted (checkpoints every 4 steps); run B trains
  9 with a fresh directory, leaves a crashed writer's ``step_….tmp``
  behind and bit-rots the newest checkpoint's largest leaf
  (``corrupt_checkpoint_leaf``); a fresh session must restore step 4,
  record 8 in ``corrupt_steps`` and train to step 10.  Params, AdamW
  moments, anchor and EF residuals bit for bit as run A's; the same plan,
  sync interval and loop counters (``blocking_replans``, as the
  reference's soak).
* Elastic membership against the reference: P = 3 -> 2 -> 3 (pod 2 killed
  at step 4, back at step 8), 12 steps, global batch 6, ``replan_every``
  4, from the reference's initial state, against the live reference
  ``TrainSession`` on a (3, 1, 1) ("pod", "data", "model") mesh with
  ``blocking_replans`` (three XLA host devices; never a data or model
  axis > 1, ROADMAP R1), in f32 as tests/test_torch_multipod.py.  The
  membership events, each step's batch rows (the port's pods hold the
  reference's global batch rows by their rank in the current
  membership), the plan and omega of every step, the pod-mean losses
  within ``LOSS_RTOL`` = 1e-5 and the final parameters within 5e-2 (that
  file's trajectory rule: gradients that differ in their last bits can
  change a code along the way).  The parameters are bit-identical on the
  port's pods after the run.  Right after the rejoin every state leaf of
  the rejoining pod is rank 0's bit for bit, and matches the row 0 the
  reference's tile gives its new pod.  The heartbeats are exchanged at
  the replan boundaries and the end of the run, and every pod holds the
  same monitor.
* R5: the same with pod 1 killed.  The port's survivors are pods 0 and 2,
  each keeping its own state; the reference cuts its pod dimension to the
  first two rows and so keeps old rows 0 and 1 (pod 1's stale state)
  while live pod 2's leaves.  The port's rule is asserted, the
  reference's printed.
* The CLI: ``--ckpt-dir`` / ``--ckpt-every`` on one pod and on two, run
  twice: the second run resumes at step 6.  With ``--deterministic`` a
  run resumed from step 2 rewrites the uninterrupted run's step-4 and
  step-6 checkpoints byte for byte; the switch (``RunConfig.
  deterministic``) is applied before the model is built.
"""
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
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-2
#: the share of an EF residual leaf's entries whose code may differ from
#: the reference's at the rejoin (0.88% is the largest seen)
EF_FLIPS = 2e-2
STEPS = 12
KILL, REJOIN = 4, 8
#: the pod killed in each elastic run: the last (both packages keep pods
#: 0 and 1), and the middle one (R5)
KILLED = (2, 1)

REF_SCRIPT = r"""
import dataclasses, json, os, sys, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import numpy as np
import jax
from repro.configs import SMOKE_ARCHS
from repro.configs.base import ACESyncConfig, RunConfig, ShapeConfig
from repro.core.trainer import Trainer
from repro.launch import train as jtrain
from repro.launch.mesh import make_mesh
from repro.launch.session import TrainSession
from repro.models.registry import build_model
from repro.runtime.faults import FaultSchedule

OUT = sys.argv[1]
A = json.loads(sys.argv[2])
run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS["paper-350m"],
                                         dtype="float32"),
                shape=ShapeConfig("session", A["seq"], 6, "train"),
                lr=A["lr"], warmup_steps=1, total_steps=50, ckpt_every=0,
                ckpt_dir=tempfile.mkdtemp(),
                acesync=ACESyncConfig(replan_every=4))
mesh = make_mesh((3, 1, 1), ("pod", "data", "model"))
out = {}

def key(path):
    return "/".join(str(getattr(q, "key", getattr(q, "name", q)))
                    for q in path)

steps = []
real_step = Trainer.step
def step(self, state, batch, plan, kind="grad_sync"):
    steps.append((self.n_pods, kind, list(plan.level_idx),
                  [float(w) for w in plan.omega],
                  np.asarray(batch["tokens"]).copy()))
    return real_step(self, state, batch, plan, kind)
Trainer.step = step

rows = []
cur = {}
real_transfer = jtrain.TrainLoop._transfer_state
def transfer(self, state, tr):
    new = real_transfer(self, state, tr)
    # which old row each new row of the EF residuals came from
    old = np.asarray(jax.tree.leaves(state["ace"].errors)[0])
    got = np.asarray(jax.tree.leaves(new["ace"].errors)[0])
    rows.append([next(i for i in range(old.shape[0])
                      if np.array_equal(got[j], old[i]))
                 for j in range(got.shape[0])])
    if got.shape[0] > old.shape[0]:
        # the whole state right after the rejoin (the tile)
        for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
            out[f"{cur['tag']}/rejoin/{key(path)}"] = np.asarray(leaf)
    return new
jtrain.TrainLoop._transfer_state = transfer

for kill in A["killed"]:
    steps.clear()
    rows.clear()
    cur["tag"] = f"k{kill}"
    sess = TrainSession(build_model(run.model, run), run, mesh=mesh,
                        strategy="acesync", blocking_replans=True,
                        fault_schedule=FaultSchedule.preempt_and_rejoin(
                            kill, A["kill"], A["rejoin"]))
    state0 = sess.init()
    if kill == A["killed"][0]:
        for path, leaf in jax.tree_util.tree_flatten_with_path(state0)[0]:
            out[f"state0/{key(path)}"] = np.asarray(leaf)
    # the R5 run only needs the rows its kill keeps
    sess.run(A["steps"] if kill == A["killed"][0] else A["kill"] + 1,
             log_every=0)
    tag = f"k{kill}"
    out[f"{tag}/losses"] = np.asarray(sess.losses)
    out[f"{tag}/events"] = np.asarray(
        [(e["step"], e["n_pods"]) for e in sess.loop.membership_events])
    out[f"{tag}/n_pods"] = np.asarray([s[0] for s in steps])
    out[f"{tag}/kinds"] = np.asarray([s[1] for s in steps])
    out[f"{tag}/levels"] = np.asarray([s[2] for s in steps])
    for i, s in enumerate(steps):
        out[f"{tag}/omega{i}"] = np.asarray(s[3])
        out[f"{tag}/tokens{i}"] = s[4]
    out[f"{tag}/rows"] = np.asarray(rows[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            sess.state["params"])[0]:
        out[f"{tag}/params/{key(path)}"] = np.asarray(leaf)
np.savez(OUT, **out)
print("REF_OK")
"""


def _session(group, ckpt_dir, every=4, **kw):
    """A session of the f32 smoke model with 2 rows per pod."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model
    P = 1 if group is None else group.size
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS["paper-350m"],
                                              dtype="float32"),
                    shape=ShapeConfig("session", SEQ, 2 * P, "train"),
                    lr=LR, warmup_steps=1, total_steps=50,
                    ckpt_dir=str(ckpt_dir), ckpt_every=every,
                    acesync=ACESyncConfig(replan_every=4))
    return TrainSession(build_model(run.model, run, device="cpu"), run,
                        strategy="acesync", pods=group, **kw)


# ---------------------------------------------------------------------------
# restart-replay
# ---------------------------------------------------------------------------


def _state_bits(sess):
    from repro_torch import tree as T
    st = sess.state
    out = {k: [x.detach().numpy().copy() for x in T.leaves(st[k])]
           for k in ("params", "m", "v", "anchor")}
    out["errors"] = [x.numpy().copy() for x in T.leaves(st["ace"].errors)]
    loop = sess.loop
    out["plan"] = (loop.plan.level_idx, loop.plan.sync_interval,
                   loop._steps_since_sync, loop._H,
                   loop.trainer.scheduler.sync_interval, int(st["step"]))
    return out


def _replay(group, tmp):
    """Run A (10 steps), run B (9 steps, a crashed writer's .tmp and a
    bit-rotted newest checkpoint), a fresh session over B's directory to
    step 10.  Returns (A's bits, B's bits, restored step, corrupt
    steps)."""
    from repro_torch.runtime import faults as F
    rank = 0 if group is None else group.rank
    a = _session(group, tmp / "A", blocking_replans=True)
    a.run(10, log_every=0)
    a.finish()
    b = _session(group, tmp / "B", blocking_replans=True)
    b.run(9, log_every=0)
    b.finish()
    if rank == 0:
        d8 = tmp / "B" / "step_00000008"
        os.makedirs(tmp / "B" / "step_00000099.tmp")
        biggest = max(os.listdir(d8), key=lambda n: (d8 / n).stat().st_size)
        assert F.corrupt_checkpoint_leaf(
            str(tmp / "B"), int(biggest.split("_")[1].split(".")[0]),
            step=8)
    if group is not None:
        group.barrier()
    b2 = _session(group, tmp / "B", blocking_replans=True)
    b2.init()
    restored = int(b2.state["step"])
    b2.run(10 - restored, log_every=0)
    b2.finish()
    return (_state_bits(a), _state_bits(b2), restored,
            b2.loop.ckpt.corrupt_steps)


def _replay_pod(group, tmp):
    return _replay(group, Path(tmp))


@pytest.mark.parametrize("n_pods", [1, 2])
def test_restart_replay_is_bit_identical(tmp_path, n_pods):
    if n_pods == 1:
        results = [_replay(None, tmp_path)]
    else:
        from repro_torch.launch.mesh import spawn_pods
        results = spawn_pods(_replay_pod, n_pods, "cpu",
                             args=(str(tmp_path),), threads=1,
                             init_method=f"file://{tmp_path / 'store'}",
                             timeout=300)
    for a, b, restored, corrupt in results:
        assert restored == 4, restored
        assert 8 in corrupt
        assert a["plan"] == b["plan"]
        for k in ("params", "m", "v", "anchor", "errors"):
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
    # both pods' checkpoints are one file per leaf with both rows
    if n_pods == 2:
        leaf = np.load(tmp_path / "A" / "step_00000008" / "leaf_0.npy")
        assert leaf.shape[0] == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pods", [1, 2])
def test_cli_resumes_from_its_checkpoint(tmp_path, pods):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--smoke", "--seq-len", str(SEQ), "--batch",
           str(2 * pods), "--steps", "6", "--ckpt-every", "2",
           "--ckpt-dir", str(tmp_path / "ck")]
    if pods > 1:
        cmd += ["--pods", str(pods)]
    outs = []
    for _ in range(2):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append((out.stdout,
                     json.loads(out.stdout.strip().splitlines()[-1])))
    (so1, r1), (so2, r2) = outs
    assert r1["start_step"] == 0 and r1["steps"] == 6
    assert "restored checkpoint" not in so1
    assert r2["start_step"] == 6 and r2["steps"] == 6
    assert "restored checkpoint @ step 6" in so2
    assert (tmp_path / "ck" / "step_00000012").is_dir()
    if pods > 1:
        assert [p["start_step"] for p in r2["pods"]] == [6] * pods


def test_cli_deterministic_resume_replays_bit_identically(tmp_path):
    """``--deterministic``: a run resumed from step 2 writes the step-4
    and step-6 checkpoints of the uninterrupted run byte for byte."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--smoke", "--seq-len", str(SEQ), "--batch", "2",
           "--steps", "6", "--ckpt-every", "2", "--ckpt-dir", str(ck),
           "--deterministic"]
    replayed = ("step_00000004", "step_00000006")
    for run in range(2):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        if run == 0:
            for d in replayed:
                (ck / d).rename(tmp_path / d)
    assert "restored checkpoint @ step 2" in out.stdout
    for d in replayed:
        leaves = sorted(p.name for p in (tmp_path / d).glob("leaf_*.npy"))
        assert leaves and leaves == sorted(
            p.name for p in (ck / d).glob("leaf_*.npy"))
        for name in leaves:
            assert (tmp_path / d / name).read_bytes() == \
                (ck / d / name).read_bytes(), (d, name)


@pytest.mark.parametrize("preset", [None, ":16:8"])
@pytest.mark.parametrize("deterministic", [True, False])
def test_deterministic_switch_precedes_the_model(tmp_path, monkeypatch,
                                                 deterministic, preset):
    """``RunConfig.deterministic`` reaches both settings before the model
    first touches the card (``build_model`` mocked: the first CUDA call),
    and leaves a ``CUBLAS_WORKSPACE_CONFIG`` already set alone."""
    from repro_torch.launch import session as S
    var = "CUBLAS_WORKSPACE_CONFIG"
    monkeypatch.setenv(var, "unset-marker")
    if preset is None:
        monkeypatch.delenv(var)
    else:
        monkeypatch.setenv(var, preset)
    events = []
    monkeypatch.setattr(S.torch, "use_deterministic_algorithms",
                        lambda on: events.append(("algorithms", on)))
    real = S.build_model

    def build(cfg, run, device):
        events.append(("build", device, os.environ.get(var)))
        return real(cfg, run, device="cpu")

    monkeypatch.setattr(S, "build_model", build)
    S.TrainSession.from_config(
        "paper-350m", smoke=True, seq_len=SEQ, batch=2, steps=2,
        device="cuda", ckpt_dir=str(tmp_path / "ck"),
        deterministic=deterministic)
    if deterministic:
        want_var = preset or ":4096:8"
        assert events[:2] == [("algorithms", True),
                              ("build", "cuda", want_var)]
    else:
        assert events[0] == ("build", "cuda", preset)
        assert ("algorithms", True) not in events


# ---------------------------------------------------------------------------
# elastic membership against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's two elastic runs (one subprocess, 3 XLA host
    devices), started with the module's first test and read when a test
    needs them."""
    tmp = tmp_path_factory.mktemp("elastic_ref")
    path = tmp / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_FORCE_INTERPRET="1")
    args = {"seq": SEQ, "lr": LR, "steps": STEPS, "kill": KILL,
            "rejoin": REJOIN, "killed": list(KILLED)}
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(path),
                             json.dumps(args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    box = {}

    def result():
        if "ref" not in box:
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
            box["ref"] = dict(np.load(path))
        return box["ref"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _elastic_pod(group, ref_path, tmp, kill):
    import torch
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.core.trainer import Trainer
    from repro_torch.runtime.faults import FaultSchedule
    ref = dict(np.load(ref_path))
    sess = _session(group, Path(tmp) / f"k{kill}", every=5,
                    blocking_replans=True,
                    fault_schedule=FaultSchedule.preempt_and_rejoin(
                        kill, KILL, REJOIN))
    sess.state = convert.pod_state_from_reference(
        {k[len("state0/"):]: v for k, v in ref.items()
         if k.startswith("state0/")}, sess.trainer, group.rank)
    loop = sess.loop
    out = {"steps": [], "kept": None, "rejoin": None}
    real_step = Trainer.step

    def step(tr, state, batch, plan, kind="grad_sync"):
        out["steps"].append((loop._host_step, tr.n_pods, kind,
                             list(plan.level_idx),
                             [float(w) for w in plan.omega],
                             list(loop._pipeline.rows),
                             batch["tokens"].numpy().copy()))
        return real_step(tr, state, batch, plan, kind)

    Trainer.step = step
    real_transfer = loop._transfer_state

    def transfer(state, tr, grp, joining):
        before = (None if state is None else
                  [x.clone() for x in T.leaves(state["ace"].errors)])
        new = real_transfer(state, tr, grp, joining)
        if before is not None and new is not None and out["kept"] is None:
            out["kept"] = all(torch.equal(x, y) for x, y in
                              zip(before, T.leaves(new["ace"].errors)))
        if joining and new is not None:
            # every pod's whole state right after the rejoin
            out["rejoin"] = [(T.path_str(p), x.detach().numpy().copy())
                             for p, x in T.reference_leaves_with_path(new)]
        return new

    loop._transfer_state = transfer
    sess.run(STEPS, log_every=0)
    sess.finish()
    out.update(
        pod=group.rank, losses=sess.losses,
        events=[(e["step"], e["n_pods"], e["members"])
                for e in loop.membership_events],
        params=[x.detach().numpy().copy()
                for x in T.leaves(sess.state["params"])],
        names=[T.path_str(p) for p, _ in
               T.leaves_with_path(sess.trainer.model.param_shapes())],
        idle=loop.idle, ckpts=sorted(os.listdir(Path(tmp) / f"k{kill}")),
        exchanges=len(loop.heartbeat_seconds), times=loop.pod_step_times,
        monitor={p: (st.alive, st.step_times)
                 for p, st in loop.monitor.pods.items()})
    return out


@pytest.fixture(scope="module")
def elastic(reference, tmp_path_factory):
    from repro_torch.launch.mesh import spawn_pods
    ref = reference()
    tmp = tmp_path_factory.mktemp("elastic")
    path = tmp / "ref.npz"
    np.savez(path, **{k: v for k, v in ref.items()
                      if k.startswith("state0/")})
    return ref, {kill: spawn_pods(
        _elastic_pod, 3, "cpu", args=(str(path), str(tmp), kill),
        threads=1, init_method=f"file://{tmp / f'store{kill}'}",
        timeout=300) for kill in KILLED}


def test_elastic_membership_matches_reference(elastic):
    """P = 3 -> 2 -> 3 with the last pod killed: the port follows the
    reference step for step."""
    ref, runs = elastic
    port = runs[2]
    tag = "k2"
    assert [e[:2] for e in port[0]["events"]] == \
        [tuple(x) for x in ref[f"{tag}/events"]] == [(KILL, 2), (REJOIN, 3)]
    assert [e[2] for e in port[0]["events"]] == [[0, 1], [0, 1, 2]]
    n_pods = [int(x) for x in ref[f"{tag}/n_pods"]]
    assert sorted(set(n_pods)) == [2, 3]
    for pod in port:
        # pod p steps where the fleet has more than p pods (pod 2 idles
        # from the kill to the rejoin), as rank p of the fleet
        mine = [i for i, P in enumerate(n_pods) if P > pod["pod"]]
        assert len(pod["steps"]) == len(mine)
        for i, (_, P, kind, levels, omega, rows, got) in zip(
                mine, pod["steps"]):
            assert P == n_pods[i]
            assert kind == str(ref[f"{tag}/kinds"][i])
            assert levels == list(ref[f"{tag}/levels"][i]), i
            np.testing.assert_allclose(omega, ref[f"{tag}/omega{i}"],
                                       rtol=1e-12)
            # the batch rows: the pod's share of the reference's global
            # batch (6 -> 4 -> 6 rows)
            tokens = ref[f"{tag}/tokens{i}"]
            assert tokens.shape[0] == 2 * P
            assert rows == [2 * pod["pod"], 2 * pod["pod"] + 1]
            np.testing.assert_array_equal(got, tokens[rows])
    for pod in port:
        assert not pod["idle"]
        np.testing.assert_allclose(pod["losses"][:KILL],
                                   ref[f"{tag}/losses"][:KILL],
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(port[0]["losses"], ref[f"{tag}/losses"],
                               rtol=LOSS_RTOL)
    for pod in port:
        for name, p in zip(pod["names"], pod["params"]):
            want = ref[f"{tag}/params/{name}"][pod["pod"]]
            np.testing.assert_allclose(p, want, atol=PARAM_ATOL,
                                       err_msg=name)
            np.testing.assert_array_equal(p, port[0]["params"][
                pod["names"].index(name)])
    # checkpoints at 5 (P = 2) and 10 (P = 3), rows by the fleet size
    assert port[0]["ckpts"] == ["LATEST", "step_00000005",
                                "step_00000010"]


def test_rejoin_adopts_rank0_state_as_the_reference_tiles(elastic):
    """Right after the rejoin (last pod killed), every leaf of the
    rejoining pod's state (params, AdamW moments, anchor, EF residuals,
    importance state) is rank 0's bit for bit; the reference's tile gives
    its new row 2 old row 0, and the rejoined state matches the
    reference's row 0: every entry within ``PARAM_ATOL`` of its leaf's
    largest magnitude (the trajectory rule, scaled to leaves such as the
    second moments that are far below 1), except that an EF residual
    entry whose gradient crossed a quantisation boundary or a top-k pick
    along the way takes that code's whole step (at most ``EF_FLIPS`` of
    a residual leaf's entries), and the divergence EMA, which reads other
    random projections than the reference's, is held only to its sign
    (as tests/test_torch_multipod.py holds both)."""
    ref, runs = elastic
    port = runs[2]
    tag = "k2/rejoin/"
    want = {k[len(tag):]: v for k, v in ref.items() if k.startswith(tag)}
    assert all(pod["rejoin"] is not None for pod in port)
    joined, rank0 = port[2]["rejoin"], port[0]["rejoin"]
    assert [p for p, _ in joined] == [p for p, _ in rank0] == list(want)
    worst, flips = 0.0, 0.0
    for (path, got), (_, own) in zip(joined, rank0):
        np.testing.assert_array_equal(got, own, err_msg=path)
        r = want[path]
        assert r.shape[0] == 3
        np.testing.assert_array_equal(r[2], r[0], err_msg=path)
        if path == "ace/div_ema":
            assert got >= 0.0 and r[0] >= 0.0
            continue
        scale = float(np.max(np.abs(r[0]), initial=0.0))
        off = np.abs(got - r[0]) > PARAM_ATOL * scale
        if path.startswith("ace/errors/"):
            flips = max(flips, float(off.mean()))
            assert off.mean() <= EF_FLIPS, (path, float(off.mean()))
            continue
        assert not off.any(), (path, float(np.max(np.abs(got - r[0]))))
        if scale:
            worst = max(worst, float(np.max(np.abs(got - r[0]))) / scale)
    print(f"rejoin: {len(joined)} leaves; largest difference from the "
          f"reference's row 0 {worst:.3g} of the leaf's largest magnitude; "
          f"EF residual entries off by a code {flips:.3%} at most")


def test_heartbeats_are_exchanged_where_the_monitor_is_read(elastic):
    """The pods exchange their step times at the replan boundaries (steps
    4 and 8, which carry the kill and the rejoin) and at the end of the
    run: three exchanges for 12 steps.  Every pod then holds the same
    monitor, each live pod beaten step by step with the first live pod's
    time (the preempted pod sends NaN), pod 2's times cleared at its
    rejoin, as the reference's monitor does."""
    _, runs = elastic
    port = runs[2]
    times = port[0]["times"]
    assert len(times) == STEPS
    for pod in port:
        assert pod["exchanges"] == 3
        assert pod["monitor"] == port[0]["monitor"]
        assert len(pod["times"]) == STEPS
        np.testing.assert_array_equal(pod["times"], times)
    for i, row in enumerate(times):
        assert np.isnan(row[2]) == (KILL <= i < REJOIN), (i, row)
        assert all(np.isfinite(row[:2]))
    first = [row[0] for row in times]
    mon = port[0]["monitor"]
    assert mon[0] == mon[1] == (True, first)
    assert mon[2] == (True, first[REJOIN:])


def test_elastic_keeps_the_survivors_own_state_r5(elastic):
    """Pod 1 killed (R5): the port's survivors are pods 0 and 2 (ranks 0
    and 1 of the P = 2 fleet), each with its own state; the reference
    keeps old rows 0 and 1 of its pod dimension."""
    ref, runs = elastic
    port = runs[1]
    assert [e[2] for e in port[0]["events"]] == [[0, 2], [0, 1, 2]]
    assert port[0]["kept"] and port[2]["kept"]
    # pod 2 trains at rank 1 while pod 1 idles
    during = [s for s in port[2]["steps"] if s[1] == 2]
    assert during and all(s[5] == [2, 3] for s in during)
    assert not [s for s in port[1]["steps"] if s[1] == 2]
    ref_rows = [int(x) for x in ref["k1/rows"]]
    print(f"R5: after pod 1's kill the reference keeps old rows {ref_rows};"
          f" the port keeps pods [0, 2]")
    for pod in port:
        assert all(np.isfinite(pod["losses"]))
