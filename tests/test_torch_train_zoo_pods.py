"""The MoE family, the RG-LRU hybrid and the encoder-decoder on P = 2
pods: the port's qwen3-moe-30b-a3b, recurrentgemma-2b and
seamless-m4t-medium SMOKE models, each on two gloo
pod processes against the live reference on a (2, 1, 1) ("pod", "data",
"model") CPU mesh, both from the reference's initial state under one
plan (the groups round-robin on all 8 ladder rungs, a non-uniform
omega, the one-shot exchange), two ``local`` steps, a ``delta_sync``
and a ``grad_sync``, in f32 compute (the MoE's routes agree).

The reference runs in a subprocess (XLA fixes its device count at first
use), its Pallas kernels interpreted (``REPRO_FORCE_INTERPRET=1``); the
port's pods rendezvous through a ``file://`` store in tmp_path.

Checked, with their tolerances:

* the pod-mean losses within ``LOSS_RTOL`` = 1e-5 relative;
* after the ``delta_sync`` the parameters bit-identical on both pods of
  the port, and within ``PARAM_ATOL`` of the reference's: a gradient that
  differs from the reference's in its last bits can move an int4 code or
  a SIGN1 vote, and the rung then moves that entry by its whole step
  (tests/test_torch_multipod.py's 5e-2);
* the bytes each pod gathered in the ``delta_sync`` and in the
  ``grad_sync`` equal ``plan_wire_bytes`` of the plan's gather rungs.
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
ARCH = "qwen3-moe-30b-a3b"
HYBRID = "recurrentgemma-2b"
ENCDEC = "seamless-m4t-medium"
P = 2
SEQ = 32
LR = 1e-2
KINDS = ("local", "local", "delta_sync", "grad_sync")
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-2
SYNCS = ("delta_sync", "grad_sync")

REF_SCRIPT = r"""
import dataclasses, json, os, sys
P = int(sys.argv[1]); OUT = sys.argv[2]
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.configs.base import ACESyncConfig, RunConfig, ShapeConfig
from repro.core.trainer import Trainer
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model

ARCH, SEQ, LR, KINDS = json.loads(sys.argv[3])
mesh = make_mesh((P, 1, 1), ("pod", "data", "model"))
run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS[ARCH],
                                         dtype="float32"),
                shape=ShapeConfig("t", SEQ, 2 * P, "train"), lr=LR,
                warmup_steps=1, total_steps=50,
                acesync=ACESyncConfig(ring_chunks=-1))
model = build_model(run.model, run)
tr = Trainer(model, run, mesh=mesh, strategy="acesync")
omega = tuple(float(x) for x in np.arange(1, P + 1) / (P * (P + 1) / 2))
plan = tr.scheduler.plan_from_levels([i % 8 for i in range(len(tr.metas))],
                                     omega)
out = {}

def dump(tag, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[f"{tag}/{key}"] = np.asarray(leaf)

state = jax.device_put(tr.init_state(jax.random.PRNGKey(0)),
                       tr.state_shardings())
dump("state0", state)
pipe = TokenPipeline(model, run.shape, seed=0)
for i, kind in enumerate(KINDS):
    b = pipe._host_batch(i)
    batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                           tr.batch_shardings(run.shape))
    state, m = tr.step(state, batch, plan, kind)
    for k, v in m.items():
        out[f"step{i}/{k}"] = np.asarray(v)
    dump(f"params{i}", state["params"])
np.savez(OUT, **out)
print("REF_OK")
"""


def _port_pod(group, ref_path, arch):
    """One pod of the port: ``arch``'s steps from the reference's initial
    state; per step the pod-mean loss, the parameters, and the bytes the
    pod gathered beside the priced ones."""
    import torch
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.codecs import plan_wire_bytes
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model

    ref = dict(np.load(ref_path))
    rank = group.rank
    run = RunConfig(model=dataclasses.replace(SMOKE_ARCHS[arch],
                                              dtype="float32"),
                    shape=ShapeConfig("t", SEQ, 2 * P, "train"), lr=LR,
                    warmup_steps=1, total_steps=50,
                    acesync=ACESyncConfig(ring_chunks=-1))
    tr = Trainer(build_model(run.model, run, device="cpu"), run,
                 strategy="acesync", pods=group)
    omega = tuple(float(x) for x in np.arange(1, P + 1) / (P * (P + 1) / 2))
    levels = [i % 8 for i in range(len(tr.metas))]
    plan = tr.scheduler.plan_from_levels(levels, omega)
    gather_rungs = [i for i, lv in enumerate(plan.levels)
                    if lv.codec.supports_ring]
    only = type(plan)(tuple(levels), plan.levels, plan.omega, 1)
    only.level_idx = tuple(li if li in gather_rungs else 7 for li in levels)
    state = convert.pod_state_from_reference(
        {k[len("state0/"):]: v for k, v in ref.items()
         if k.startswith("state0/")}, tr, rank)
    pipe = TokenPipeline(tr.model, run.shape, seed=0, pod=rank, n_pods=P)
    out = {"priced": plan_wire_bytes(only, tr.sizes, P),
           "names": [T.path_str(p) for p, _ in
                     T.leaves_with_path(tr.model.param_shapes())]}
    for i, kind in enumerate(KINDS):
        batch = {k: torch.from_numpy(v)
                 for k, v in pipe.host_batch(i).items()}
        group.log.clear()
        state, m = tr.step(state, batch, plan, kind)
        out[f"step{i}"] = {k: float(v) for k, v in m.items()}
        out[f"params{i}"] = [x.detach().numpy().copy()
                             for x in T.leaves(state["params"])]
        out[f"bytes{i}"] = group.bytes_logged("gather")
    return out


def _runs(tmp_path_factory, arch):
    from repro_torch.launch.mesh import spawn_pods
    tmp = tmp_path_factory.mktemp(f"{arch}_pods")
    path = tmp / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_FORCE_INTERPRET="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(P), str(path),
         json.dumps([arch, SEQ, LR, KINDS])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        so, se = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    port = spawn_pods(_port_pod, P, "cpu", args=(str(path), arch),
                      init_method=f"file://{tmp / 'store'}", threads=1,
                      timeout=600)
    return dict(np.load(path)), port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(tmp_path_factory, ARCH)


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    return _runs(tmp_path_factory, HYBRID)


@pytest.fixture(scope="module")
def encdec_runs(tmp_path_factory):
    return _runs(tmp_path_factory, ENCDEC)


def _losses_match(ref, port):
    with_loss = [i for i, k in enumerate(KINDS) if k != "delta_sync"]
    tl = [port[0][f"step{i}"]["loss"] for i in with_loss]
    jl = [float(ref[f"step{i}/loss"]) for i in with_loss]
    print("losses port", tl, "reference", jl)
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for i in with_loss:
        assert port[1][f"step{i}"]["loss"] == port[0][f"step{i}"]["loss"]


def _bit_identical_after_delta_sync(ref, port):
    i = KINDS.index("delta_sync")
    names = port[0]["names"]
    for a, b in zip(port[0][f"params{i}"], port[1][f"params{i}"]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    # after the local steps before it they differ
    assert not all(np.array_equal(a, b) for a, b in
                   zip(port[0][f"params{i - 1}"], port[1][f"params{i - 1}"]))
    worst = 0.0
    for p in range(P):
        for name, got in zip(names, port[p][f"params{i}"]):
            want = ref[f"params{i}/{name}"][p]
            d = float(np.abs(got - want).max())
            assert d <= PARAM_ATOL, (name, p, d)
            worst = max(worst, d)
    print("largest parameter difference after the delta_sync", worst)


def _gather_the_priced_bytes(port):
    for p in range(P):
        for kind in SYNCS:
            i = KINDS.index(kind)
            assert port[p][f"bytes{i}"] == port[p]["priced"] > 0, (p, kind)
        assert port[p]["bytes0"] == 0


def test_moe_pod_losses_match_live_reference(runs):
    _losses_match(*runs)


def test_moe_pods_bit_identical_after_delta_sync(runs):
    _bit_identical_after_delta_sync(*runs)


def test_moe_pods_gather_the_priced_bytes(runs):
    _gather_the_priced_bytes(runs[1])


def test_hybrid_pod_losses_match_live_reference(hybrid_runs):
    _losses_match(*hybrid_runs)


def test_hybrid_pods_bit_identical_after_delta_sync(hybrid_runs):
    """recurrentgemma-2b's tree (its ``tail/slot{i}`` leaves of shape (1,
    ...) among them) after the ``delta_sync``: bit-identical on both pods,
    within ``PARAM_ATOL`` of the reference's."""
    _bit_identical_after_delta_sync(*hybrid_runs)


def test_hybrid_pods_gather_the_priced_bytes(hybrid_runs):
    _gather_the_priced_bytes(hybrid_runs[1])


def test_encdec_pod_losses_match_live_reference(encdec_runs):
    """seamless-m4t-medium, each pod fed its rows of the pipeline's
    seeded frames."""
    _losses_match(*encdec_runs)


def test_encdec_pods_bit_identical_after_delta_sync(encdec_runs):
    """The encoder-decoder's tree (``dec_blocks`` with cross-attention,
    ``enc_blocks``, ``enc_norm``) after the ``delta_sync``: bit-identical
    on both pods, within ``PARAM_ATOL`` of the reference's."""
    _bit_identical_after_delta_sync(*encdec_runs)


def test_encdec_pods_gather_the_priced_bytes(encdec_runs):
    _gather_the_priced_bytes(encdec_runs[1])
