"""Checkpoints on a within-pod ("data", "model") mesh against the live
reference, on the CPU — the shared body of
``tests/test_torch_mesh_ckpt_<D>x<M>.py``, one file per mesh (each file
is one worker's critical path).  The rank code is
``tests/torch_mesh_ckpt_ranks.py``.

The reference runs ``Trainer(mesh=make_mesh((D, M), ("data",
"model")))`` on ``--xla_force_host_platform_device_count=4`` host
devices in a subprocess: for each arch (SMOKE qwen3-8b: tensor and vocab
parallelism; qwen3-moe-30b-a3b and dbrx-132b: experts over "model",
FSDP over "data"; f32 compute) its state after two ``grad_sync`` steps
on the mesh, saved by its ``Checkpointer`` (host-gathered whole leaves)
and written out whole.  The port's ranks (``spawn_mesh``, ``file://``
rendezvous) start from that state (``convert.state_from_reference``)
and save it on the mesh; the reference then restores the port's
checkpoint with ``shardings=state_shardings()`` on its mesh and with no
mesh.  Checked:

* (i) the port's leaf files byte for byte the reference's, and the
  manifests' shape / dtype / crc32 equal;
* (ii) the reference restores the port's checkpoint bit for bit, on its
  mesh and without one;
* (iii) every rank restores the reference's checkpoint to the
  reference's leaves cut by its shard index, bit for bit, and one
  process without a mesh to the whole leaves;
* (iv)-(vii) the loop on the mesh (``torch_mesh_ckpt_ranks.loop_cases``):
  a resumed run replays the uninterrupted one (state shards, host state
  and losses bit for bit, its step-4 files byte for byte); a corrupt
  leaf makes every rank fall back to the same step and record it; a
  shard write failing on rank 1 fails the save on every rank, the
  previous checkpoint intact, the ``.tmp`` pruned; another arch's
  checkpoint raises ``ValueError`` naming the leaf on every rank.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from torch_mesh_ckpt_ranks import LOOP_EVERY, LOOP_STEPS, STEP
from torch_mesh_train_ranks import BATCH, LR, SEQ

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "dbrx-132b")

REF_SCRIPT = r"""
import dataclasses, json, os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.checkpoint.checkpointer import Checkpointer
from repro.configs import SMOKE_ARCHS
from repro.configs.base import RunConfig, ShapeConfig
from repro.core.trainer import Trainer
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model

A = json.loads(sys.argv[1])
OUT = A["out"]
D, M = A["mesh"]
mesh = make_mesh((D, M), ("data", "model"), devices=jax.devices()[:D * M])


def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


trainers, saved = {}, {}
for arch in A["archs"]:
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS[arch],
                                              dtype="float32"),
                    shape=ShapeConfig("t", A["seq"], A["batch"], "train"),
                    lr=A["lr"], warmup_steps=1, total_steps=50)
    model = build_model(run.model, run)
    tr = Trainer(model, run, mesh=mesh, strategy="acesync")
    plan = tr.default_plan()
    state = jax.device_put(tr.init_state(jax.random.PRNGKey(0)),
                           tr.state_shardings())
    pipe = TokenPipeline(model, run.shape, seed=0)
    for i in range(A["step"]):
        b = pipe._host_batch(i)
        batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                               tr.batch_shardings(run.shape))
        state, _ = tr.step(state, batch, plan, "grad_sync")
    Checkpointer(os.path.join(OUT, "ref", arch)).save(
        A["step"], state, extras={"arch": arch}, blocking=True)
    flat = {key_of(p): np.asarray(x)[0] for p, x in
            jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]}
    saved[arch] = flat
    trainers[arch] = tr
    # written whole, then renamed: the port's ranks start once every
    # arch's state is there
    path = os.path.join(OUT, f"{arch}_state.npz")
    np.savez(path + ".tmp.npz", **flat)
    os.replace(path + ".tmp.npz", path)

deadline = time.monotonic() + 600
while not os.path.exists(os.path.join(OUT, "port_done")):
    assert time.monotonic() < deadline, "the port's ranks never finished"
    time.sleep(0.2)

res = {}
for arch, tr in trainers.items():
    ck = Checkpointer(os.path.join(OUT, "port", arch))
    specs = tr.state_specs()
    for tag, sh in (("mesh", tr.state_shardings()), ("no_mesh", None)):
        got, extras = ck.restore(specs, shardings=sh)
        bad = [key_of(p) for p, x in
               jax.tree_util.tree_flatten_with_path(got)[0]
               if np.asarray(x)[0].tobytes()
               != np.ascontiguousarray(saved[arch][key_of(p)]).tobytes()]
        res[f"{arch}/{tag}"] = {"bad": bad, "extras": extras,
                                "n": len(jax.tree.leaves(got))}
with open(os.path.join(OUT, "ref_restores.json"), "w") as f:
    json.dump(res, f)
print("REF_OK")
"""


def run_mesh(tmp: Path, mesh, archs=ARCHS, loop=True) -> tuple:
    """(the reference's restores of the port's checkpoints, [the port's
    ``ckpt_rank`` result per rank]) on ``mesh``, the ranks running the
    loop cases where ``loop``; the checkpoints and the reference's states
    stay in ``tmp``."""
    from repro_torch.launch.mesh import spawn_mesh
    from torch_mesh_ckpt_ranks import ckpt_rank
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    args = {"mesh": mesh, "archs": list(archs), "seq": SEQ, "batch": BATCH,
            "lr": LR, "step": STEP, "out": str(tmp)}
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(args)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        states = [tmp / f"{a}_state.npz" for a in archs]
        deadline = time.monotonic() + 600
        while not all(p.exists() for p in states):
            if proc.poll() is not None or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        try:
            port = spawn_mesh(ckpt_rank, *mesh, "cpu",
                              args=(list(archs), str(tmp), loop),
                              init_method=f"file://{tmp / 'store'}",
                              threads=1, timeout=600)
        finally:
            (tmp / "port_done").touch()
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ref = json.loads((tmp / "ref_restores.json").read_text())
    return ref, port


def _leaf_files(d: Path) -> dict:
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
            if n.startswith("leaf_")}


def _manifest(d: Path) -> dict:
    return json.loads((d / "manifest.json").read_text())


def check_files(tmp: Path, arch) -> None:
    """(i): the port's mesh checkpoint = the reference's, byte for byte."""
    p = tmp / "port" / arch / f"step_{STEP:08d}"
    r = tmp / "ref" / arch / f"step_{STEP:08d}"
    assert _leaf_files(p) == _leaf_files(r)
    mp, mr = _manifest(p), _manifest(r)
    assert mp["leaves"] == mr["leaves"] and mp["n_leaves"] == mr["n_leaves"]
    assert mp["extras"] == mr["extras"] == {"arch": arch}
    assert mp["treedef_repr"] is None and len(mp["leaf_paths"]) == \
        mp["n_leaves"]


def check_reference_restores(ref, arch) -> None:
    """(ii): the reference reads the port's checkpoint back bit for bit,
    on its mesh and with no mesh."""
    for tag in ("mesh", "no_mesh"):
        got = ref[f"{arch}/{tag}"]
        assert got["bad"] == [] and got["n"] > 0, (tag, got["bad"])
        assert got["extras"] == {"arch": arch}


def check_port_restores(tmp: Path, port, arch) -> None:
    """(iii): every rank's restored shards are the reference's leaves cut
    by the rank's index, bit for bit; and one process without a mesh
    restores the whole leaves."""
    from repro_torch import convert
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.trainer import Trainer
    from repro_torch.models.registry import build_model
    from torch_mesh_train_ranks import run_config
    want = dict(np.load(tmp / f"{arch}_state.npz"))
    for r in port:
        got = r["archs"][arch]
        assert got["extras"] == {"arch": arch}
        assert set(got["restored"]) == set(want)
        for key, (part, index, shape) in got["restored"].items():
            assert tuple(shape) == want[key].shape, key
            np.testing.assert_array_equal(part, want[key][index],
                                          err_msg=f"rank {r['rank']} {key}")
    run = run_config(arch)
    tr = Trainer(build_model(run.model, run, device="cpu"), run)
    st, extras = Checkpointer(str(tmp / "ref" / arch)).restore(
        tr.init_state(99))
    assert extras == {"arch": arch}
    for key, (whole, _, _) in convert.rank_shards(st, tr).items():
        np.testing.assert_array_equal(whole, want[key], err_msg=key)


def check_save_numbers(port, arch) -> None:
    """The save's bytes: the checkpoint's on every rank, the ranks'
    written bytes at least the checkpoint's (replicated shards are
    written once), each rank's no more than the checkpoint's."""
    saves = [r["archs"][arch]["save"] for r in port]
    total = saves[0]["bytes"]
    assert all(s["bytes"] == total for s in saves)
    assert sum(s["rank_bytes"] for s in saves) == total
    assert "crc_s" in saves[0] and all(s["write_s"] > 0 for s in saves)


def check_resume(tmp: Path, port) -> None:
    """(iv): the resumed run replays the uninterrupted one on every rank,
    and rewrites its step-4 checkpoint byte for byte."""
    for r in port:
        lp = r["loop"]
        assert lp["b_restored"] == LOOP_EVERY
        a, b = lp["a"], lp["b"]
        assert b["host"] == a["host"] and b["host"][-1] == LOOP_STEPS
        assert b["losses"] == a["losses"][LOOP_EVERY:]
        for key, x in a["shards"].items():
            np.testing.assert_array_equal(b["shards"][key], x, err_msg=key)
    a = tmp / "A" / f"step_{LOOP_STEPS:08d}"
    b = tmp / "B" / f"step_{LOOP_STEPS:08d}"
    assert _leaf_files(a) and _leaf_files(a) == _leaf_files(b)
    assert _manifest(a)["leaves"] == _manifest(b)["leaves"]


def check_corruption(port) -> None:
    """(v): every rank restores the same earlier step and records the
    same corrupt step."""
    want = (LOOP_STEPS - LOOP_EVERY, [LOOP_STEPS])
    assert [tuple(r["loop"]["c"]) for r in port] == [want] * len(port)


def check_write_failure(port) -> None:
    """(vi): the failure on rank 1 raises on every rank; the previous
    checkpoint stays and verifies; prune removes the ``.tmp``."""
    for r in port:
        f = r["loop"]["fail"]
        assert f["err"] and "failed in the background" in f["err"], f
        assert "injected shard write failure" in f["err"] or \
            "failed on rank 1" in f["err"], f["err"]
        assert f["latest"] == 1 and f["verified"]
        assert f["tmp_left"] and not f["tmp_after_prune"]


def check_other_arch(port) -> None:
    """(vii): another arch's checkpoint raises ValueError naming the
    leaf, the same on every rank."""
    errs = [r["loop"]["other"] for r in port]
    assert errs[0] and all(e == errs[0] for e in errs), errs
    assert "ace/errors/blocks/slot0/attn/wk" in errs[0], errs[0]
