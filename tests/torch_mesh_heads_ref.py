"""Query heads that "model" does not divide, against the live reference on
the CPU — the shared body of a test in the mesh test file of each family
(``tests/test_torch_mesh_train.py``: SMOKE starcoder2-3b, dense;
``tests/test_torch_mesh_recurrent.py``: SMOKE recurrentgemma-2b, the
hybrid), each cut to 3 query heads of 16 columns and one K/V head
(``torch_mesh_heads_ranks.HEADS``): on (1, 2) the reference's fit rule
splits the 48 columns of wq / wo in halves, so a rank holds parts of
heads, and the port computes the heads its part touches whole.

The reference runs in one subprocess on 4 forced XLA host devices: its
``Server(mesh=)``'s prefill and teacher-forced decode steps, and its
``Trainer(mesh=)``'s first ``local`` step.  The port's ranks
(``spawn_mesh``, gloo, ``file://`` rendezvous; rank code
``tests/torch_mesh_heads_ranks.py``) take the reference's weights and
initial state.  Checked, at the tolerances the mesh files state: each
rank's vocabulary part of the logits within 1e-5 relative
(``tests/test_torch_mesh_recurrent_serve.py``); the step's loss and grad
norm within ``LOSS_RTOL`` = 1e-5 and each parameter shard within
``STATE_RTOL`` = 1e-4 of its leaf's norm (``tests/torch_mesh_train_ref.py``);
the state the ranks saved after the step restores onto one process
without a mesh, every parameter the ranks' shards bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from torch_mesh_heads_ranks import (B, BATCH, CACHE, HEADS, LR, SEQ, SP,
                                    STEP, STEPS, heads_rank, run_config)
from torch_mesh_train_ref import LOSS_RTOL, STATE_RTOL

ROOT = Path(__file__).resolve().parents[1]
MESH = (1, 2)
RTOL = 1e-5

REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.configs.base import RunConfig, ShapeConfig
from repro.core.trainer import Trainer
from repro.data.pipeline import TokenPipeline
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model

A = json.loads(sys.argv[1])
D, M = A["mesh"]
mesh = make_mesh((D, M), ("data", "model"), devices=jax.devices()[:D * M])
cfg = dataclasses.replace(SMOKE_ARCHS[A["arch"]], dtype="float32",
                          **A["heads"])
out = {}


def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def flat(tree, tag, pod=False):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[f"{tag}/{key_of(path)}"] = a[0] if pod else a


model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
flat(params, "params")
B, SP, CACHE, STEPS = A["tf"]
toks = jnp.asarray(np.load(A["tokens"]))
server = jserve.Server(model, CACHE, B, mesh=mesh)
logits, caches = server._prefill(params, {"tokens": toks[:, :SP]}, CACHE)
out["logits0"] = np.asarray(logits)
for i in range(STEPS):
    logits, caches = server._decode(params, caches, jnp.int32(SP + i),
                                    toks[:, SP + i:SP + i + 1])
    out[f"logits{i + 1}"] = np.asarray(logits)

seq, batch, lr = A["train"]
run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, batch, "train"),
                lr=lr, warmup_steps=1, total_steps=50)
model = build_model(cfg, run)
tr = Trainer(model, run, mesh=mesh, strategy="acesync")
state0 = jax.device_get(tr.init_state(jax.random.PRNGKey(0)))
flat(state0, "state0", pod=True)
b = TokenPipeline(model, run.shape, seed=0)._host_batch(0)
state, m = tr.step(jax.device_put(state0, tr.state_shardings()),
                   jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                  tr.batch_shardings(run.shape)),
                   tr.default_plan(), "local")
out["loss"], out["grad_norm"] = np.asarray(m["loss"]), np.asarray(
    m["grad_norm"])
flat(state["params"], "after", pod=True)
np.savez(A["out"], **out)
print("REF_OK")
"""


def run(tmp: Path, arch: str) -> tuple:
    """(the reference's results, [the port's result per rank], the
    one-process restore of the ranks' checkpoint: its parameters by
    path)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.trainer import Trainer
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.models.registry import build_model
    from torch_mesh_train_ranks import flat_state
    toks = np.random.RandomState(1).randint(
        0, 256, size=(B, SP + STEPS)).astype(np.int32)
    np.save(tmp / "tokens.npy", toks)
    args = {"arch": arch, "mesh": MESH, "heads": HEADS,
            "tf": (B, SP, CACHE, STEPS), "train": (SEQ, BATCH, LR),
            "tokens": str(tmp / "tokens.npy"), "out": str(tmp / "ref.npz")}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and "REF_OK" in out.stdout, \
        out.stderr[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = spawn_mesh(heads_rank, *MESH, "cpu",
                      args=(arch, str(tmp / "ref.npz"), toks,
                            str(tmp / "ckpt")),
                      init_method=f"file://{tmp / 'store'}", threads=1,
                      timeout=600)
    run_ = run_config(arch)
    tr = Trainer(build_model(run_.model, run_, device="cpu"), run_,
                 strategy="acesync")
    state, _ = Checkpointer(str(tmp / "ckpt")).restore(tr.init_state(99))
    restored = {k: v for k, v in flat_state(state).items()
                if k.startswith("params/")}
    restored["step"] = int(state["step"])
    return ref, port, restored


def _vocab_part(a, m):
    n = a.shape[-1] // MESH[1]
    return a[..., m * n:(m + 1) * n]


def check_serve(ref, port) -> None:
    for r in port:
        _, m = r["coords"]
        for i in range(STEPS + 1):
            want = _vocab_part(ref[f"logits{i}"], m)
            got = r[f"logits{i}"]
            assert got.shape == want.shape, i
            np.testing.assert_allclose(
                got, want, rtol=RTOL,
                atol=RTOL * float(np.abs(want).max()), err_msg=f"logits{i}")


def check_train(ref, port) -> None:
    for r in port:
        for k in ("loss", "grad_norm"):
            w = float(ref[k])
            assert abs(r[k] - w) <= LOSS_RTOL * abs(w), (k, r[k], w)
        for key, g in r["params"].items():
            path = key[len("params/"):]
            w = ref[f"after/{path}"][r["index"][path]]
            assert g.shape == w.shape, key
            err = float(np.abs(g.astype(np.float64) - w).max())
            assert err <= STATE_RTOL * float(np.linalg.norm(w)), (key, err)


def check_restore(port, restored) -> None:
    """Every parameter of the one-process restore is the ranks' shards,
    bit for bit, and at the saved step."""
    assert restored.pop("step") == STEP
    for key, whole in restored.items():
        path = key[len("params/"):]
        for r in port:
            np.testing.assert_array_equal(whole[r["index"][path]],
                                          r["params"][key], err_msg=key)
