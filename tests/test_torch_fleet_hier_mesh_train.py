"""A two-tier fleet of ("data", "model") meshes: training, checkpoints and
the CLI on C = 2 clusters x E = 2 members, each member a (1, 2) mesh —
the port's gloo ranks on the CPU (``spawn_fleet_mesh(..., n_edge=2)``,
``file://`` rendezvous; rank code in
``tests/torch_fleet_hier_mesh_ranks.py``), SMOKE paper-350m in f32
compute.

The reference's multi-pod trainer aborts on such meshes on the CPU
(ROADMAP R1), so each member is held to the live reference's one-pod
``Trainer(mesh=make_mesh((1, 2), ("data", "model")))`` on its rows of
each global batch, from its initial state (tests/
test_torch_fleet_mesh_train.py's reference script, run for four pods);
the two-tier round on each rank is held to the reference's by
tests/test_torch_fleet_hier_mesh.py.  Checked:

* (b) ``acesync_hier`` through ``TrainSession``, 16 edge devices,
  ``sync_interval_init`` 3 and ``replan_every`` 3 (three ``local``
  steps, a ``delta_sync``, a device replan that re-clusters, another
  ``delta_sync``): before the first sync the fleet-mean losses and grad
  norms within ``LOSS_RTOL`` = 1e-5 relative of the mean of the
  reference's four members, and each member's gathered params, m, v and
  error buffers within ``STATE_RTOL`` = 1e-4 of each leaf's norm of the
  reference's (tests/torch_mesh_train_ref.py's tolerances); after each
  sync every parameter shard bit-identical across the four members;
  the bytes each (d, m)'s groups received per tier equal to the priced
  bytes of its local layout, a two-tier rung among them; H, the step
  kinds, the plan's levels, tier grid and omega, and the clusters
  identical on all eight ranks.
* (c) the checkpoint at the end: its leaf files byte for byte, and its
  shapes, dtypes and CRCs, those the reference's ``Checkpointer`` writes
  for the same stacked (4, ...) state; restored onto (2, 2, 2, 1), onto
  2 x 2 one-card members and onto one card (row 0), each assembling
  (``convert.reference_from_shards`` with the fleet slot) to that state
  bit for bit.
* (d) the CLI's ``--pods 4 --edge 2 --data 1 --model 2 --strategy
  acesync_hier`` prints each rank's cluster, member, bytes per tier and
  last loss.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch_fleet_hier_mesh_ranks as R
import torch_fleet_mesh_ranks as FR
from test_torch_fleet_mesh_train import REF_SCRIPT, TREES

ROOT = Path(__file__).resolve().parents[1]
ARCH = "paper-350m"
C, E = 2, 2
F = C * E
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """(the reference's one-pod runs of the four members (npz), [the
    port's ``session_rank`` per rank], the checkpoint directory): the
    port's ranks start once the reference has written the initial
    state."""
    from repro_torch.launch.mesh import spawn_fleet_mesh
    tmp = tmp_path_factory.mktemp("fleet_hier_train")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    args = {"pods": F, "archs": [ARCH], "seq": FR.SEQ,
            "batch": FR.BATCH // 2 * F, "lr": FR.LR, "steps": R.PRE_SYNC,
            "trees": list(TREES), "out": str(tmp)}
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        init = tmp / f"{ARCH}_init.npz"
        deadline = time.monotonic() + 600
        while not init.exists():
            if proc.poll() not in (None, 0) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        port = spawn_fleet_mesh(
            R.session_rank, F, 1, 2, "cpu", n_edge=E,
            args=(str(init), str(tmp / "ck")),
            init_method=f"file://{tmp / 'store'}", threads=1, timeout=600)
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return dict(np.load(tmp / f"{ARCH}.npz")), port, tmp / "ck"


def test_each_member_before_the_first_sync_is_the_references(session):
    from repro_torch import convert
    want, port, _ = session
    for r in port:
        assert r["n_edge"] == E and r["hier_enabled"]
        kinds = [s["kind"] for s in r["steps"]]
        assert kinds[:R.PRE_SYNC + 1] == ["local"] * R.PRE_SYNC + [
            "delta_sync"]
        for i in range(R.PRE_SYNC):
            for k in ("loss", "grad_norm"):
                w = np.mean([float(want[f"pod{p}/step{i}/{k}"])
                             for p in range(F)])
                g = r["history"][i][k]
                assert abs(g - w) <= LOSS_RTOL * abs(w), (r["pod"], i, k)
    stacked = convert.reference_from_shards([r["pre"] for r in port],
                                            pods=[r["pod"] for r in port])
    for p in range(F):
        for key, whole in stacked.items():
            tree = next((t for t in TREES if key.startswith(t + "/")), None)
            if tree is None:
                continue
            w = want[f"pod{p}/{key}"]
            assert whole[p].shape == w.shape, key
            err = float(np.abs(whole[p].astype(np.float64) - w).max())
            assert err <= STATE_RTOL * float(np.linalg.norm(w)), (p, key,
                                                                    err)


def test_shards_are_the_same_on_every_member_after_each_sync(session):
    _, port, _ = session
    syncs = 0
    for r in port:
        mate = next(q for q in port if q["rank"] == r["rank"]
                    and q["pod"] == 0)
        for a, b in zip(r["steps"], mate["steps"]):
            assert (a["step"], a["kind"]) == (b["step"], b["kind"])
            if "params" in a:
                syncs += 1
                assert a["params"] == b["params"], (r["pod"], a["step"])
    assert syncs == 2 * len(port)


def test_each_cells_tier_bytes_are_the_priced_ones(session):
    _, port, _ = session
    for r in port:
        grids = [s["tier_grid"] for s in r["steps"] if "bytes" in s]
        assert len(grids) == 2
        assert all(any(any(h) for h in g) for g in grids), grids
        for s in r["steps"]:
            if "bytes" in s:
                assert tuple(s["bytes"]) == tuple(s["priced"]), s["step"]
                assert min(s["priced"]) > 0


def test_h_plan_tiers_omega_and_clusters_are_the_same_on_every_rank(
        session):
    _, port, _ = session
    keys = ("step", "kind", "H", "levels", "hier", "omega", "clusters",
            "updates")
    first = [{k: s[k] for k in keys} for s in port[0]["steps"]]
    assert first[-1]["step"] == R.STEPS_RUN
    assert any(first[0]["hier"])
    # the replan re-clusters: the clustering's updates grow with it
    assert first[-1]["updates"] > first[0]["updates"]
    assert len(first[0]["clusters"]) == R.N_EDGE_DEVICES
    assert set(first[-1]["clusters"]) <= set(range(C))
    assert [r["slot"] for r in port] == [(p // E, p % E) for p in range(F)
                                         for _ in range(2)]
    for r in port:
        assert r["replans"] == 1
        got = [{k: s[k] for k in keys} for s in r["steps"]]
        assert got == first, (r["pod"], r["rank"])
        assert r["losses"] == port[0]["losses"]


@pytest.fixture(scope="module")
def checkpoint(session, tmp_path_factory):
    """(the stacked state the (2, 2, 1, 2) ranks saved, its directory, the
    reference's checkpoint of it, and the restores {target: assembled
    state})."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.configs.base import RunConfig as JRun, ShapeConfig as JShape
    from repro.core.trainer import Trainer as JTrainer
    from repro.models.registry import build_model as jbuild
    from repro_torch import convert
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.trainer import Trainer
    from repro_torch.launch.mesh import spawn_fleet_mesh, spawn_pods
    from repro_torch.models.registry import build_model
    _, port, ck = session
    tmp = tmp_path_factory.mktemp("fleet_hier_ckpt")
    stacked = convert.reference_from_shards([r["saved"] for r in port],
                                            pods=[r["pod"] for r in port])
    jrun = JRun(model=dataclasses.replace(J_SMOKE[ARCH], dtype="float32"),
                shape=JShape("t", FR.SEQ, FR.BATCH, "train"), lr=FR.LR,
                warmup_steps=1, total_steps=50)
    jt = JTrainer(jbuild(jrun.model, jrun), jrun, mesh=None,
                  strategy="acesync_hier")
    treedef = jax.tree_util.tree_structure(
        jax.eval_shape(jt.init_state, jax.random.PRNGKey(0)))
    step = port[0]["step"]
    JCheckpointer(str(tmp / "ref")).save(
        step, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(x) for x in stacked.values()]),
        extras={}, blocking=True)
    restores = {
        "2x2x2x1": spawn_fleet_mesh(
            FR.restore_rank, F, 2, 1, "cpu", n_edge=E,
            args=(ARCH, str(ck)), init_method=f"file://{tmp / 'st221'}",
            threads=1, timeout=600),
        "2x2-one-card": spawn_pods(
            FR.restore_pod, F, "cpu", n_edge=E, args=(ARCH, str(ck)),
            init_method=f"file://{tmp / 'st_one'}", threads=1,
            timeout=600)}
    run = FR.run_config(ARCH, 1)
    tr = Trainer(build_model(run.model, run, device="cpu"), run,
                 strategy="acesync")
    state, _ = Checkpointer(str(ck)).restore(tr.init_state(0))
    torch.set_num_threads(1)
    restores["one-card"] = [{"pod": 0, "step": int(state["step"]),
                             "shards": convert.rank_shards(state, tr)}]
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
    assert all(m["shape"][0] == F for m in mp["leaves"])


@pytest.mark.parametrize("target", ["2x2x2x1", "2x2-one-card", "one-card"])
def test_checkpoint_restores_onto_other_fleets(checkpoint, target):
    from repro_torch import convert
    stacked, _, _, restores = checkpoint
    res = restores[target]
    got = convert.reference_from_shards([r["shards"] for r in res],
                                        pods=[r["pod"] for r in res])
    rows = [0] if target == "one-card" else list(range(F))
    assert all(r["step"] == R.STEPS_RUN for r in res)
    for key, want in stacked.items():
        np.testing.assert_array_equal(got[key].view(np.uint8),
                                      want[rows].view(np.uint8), key)


def test_cli_trains_a_two_tier_fleet_of_meshes(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--pods", "4", "--edge", "2", "--data", "1", "--model", "2",
                "--strategy", "acesync_hier", "--smoke", "--device", "cpu",
                "--seq-len", "32", "--batch", "8", "--steps", "4",
                "--ckpt-dir", str(tmp_path / "ck")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["pods"], out["edge"], out["data"], out["model"]) == (4, 2, 1,
                                                                    2)
    ranks = out["ranks"]
    assert [(r["pod"], r["cluster"], r["member"], r["rank"])
            for r in ranks] == [(p, p // 2, p % 2, m) for p in range(4)
                                for m in range(2)]
    assert len({r["last_loss"] for r in ranks}) == 1
    assert np.isfinite(ranks[0]["last_loss"])
    assert all(r["wire_bytes"] > 0 and r["intra_bytes"] > 0 for r in ranks)
