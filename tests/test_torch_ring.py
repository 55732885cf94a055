"""The port's chunked ring exchange: its chunk grid against the
reference's, and its ``sync_tree`` rounds on P = 2, 3 and 4 gloo pods
against the port's own one-shot exchange and against the reference's ring
on a (P, 1, 1) CPU mesh.

* Grids: ``ring_hops``, ``ring_chunk_count`` and ``exec_grid`` over a
  sweep of (codec, rung size, P, bidir, ring), with the port's link
  constants set to the reference's TPU values for the test, so that both
  roofline heuristics read the same numbers: equal, element for element.
* Pods (``spawn_pods``, one gloo process per pod, ``file://``
  rendezvous): one plan with an INT8, TOPK10, SIGN1, INT4, FULL and SKIP
  rung and per-pod distinct gradients, through the one-shot exchange,
  forced K = 2 and K = 3, and the roofline's own grid (constants set so
  that it rings rungs of a few blocks); P = 4 runs the asymmetric 2 + 1
  half-rings and the one-directional ring.  Every ring aggregate and
  residual equals the one-shot's bit for bit, on every pod, and the
  aggregate is the same on every pod; the bytes the pod group logged
  (gather + ring) equal ``plan_wire_bytes`` of the gather rungs.
* Reference: the same inputs through the reference's ``sync_tree`` on a
  (P, 1, 1) mesh under forced K = 2 (shard_map, interpreted kernels, as
  tests/test_collectives.py runs it).  P = 3, 4: bit for bit, except the
  SIGN1 rung (its block scale is summed in another order: <= 8 ulp of the
  scale, plus one fixed-point unit per pod).  P = 2: the reference folds
  each pod's own payload first (ROADMAP R3: its two pods can differ), the
  port in pod order, so INT8 / INT4 aggregates may differ by 2 ulp of
  sum_p w_p * absmax_p of their block (the bound tests/test_torch_multipod.py
  states for the one-shot fold) and SIGN1 as above.  Residuals are bit for
  bit everywhere but SIGN1.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
LEVELS = (("INT8", 1.0, 8), ("TOPK10", 0.10, 8), ("SIGN1", 1.0, 1),
          ("INT4", 1.0, 4), ("FULL", 1.0, 16), ("SKIP", 0.0, 0))
#: leaf sizes, one leaf per rung above (not all block multiples)
SIZES = (6144 * 3 + 17, 8192, 8192, 6144, 2048, 700)
INT8_RUNG, INT4_RUNG, SIGN_RUNG = 0, 3, 2
SIGN_ULP = 8
PODS = (2, 3, 4)
#: the reference's roofline constants (repro/launch/mesh.py,
#: repro/core/planexec.py), set on the port for the grid comparison
REF_CONSTANTS = {"LINK_BW": 6.25e9, "HBM_BW": 819e9,
                 "RING_HOP_LATENCY_S": 10e-6, "RING_TARGET_CHUNK_S": 500e-6}
#: constants under which the roofline rings rungs of a few blocks
SMALL_CONSTANTS = {"LINK_BW": 1e6, "HBM_BW": 1e6,
                   "RING_HOP_LATENCY_S": 1e-9, "RING_TARGET_CHUNK_S": 1e-3}


def _inputs(n_pods):
    r = np.random.RandomState(11)
    g = [r.randn(n_pods, n).astype(np.float32) for n in SIZES]
    e = [(r.randn(n_pods, n) * 0.3).astype(np.float32) for n in SIZES]
    return g, e


def _omega(n_pods):
    return tuple(float(x) for x in
                 np.arange(1, n_pods + 1) / (n_pods * (n_pods + 1) / 2))


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


# ---------------------------------------------------------------------------
# the chunk grid
# ---------------------------------------------------------------------------


def test_ring_hops_match_reference():
    from repro.core import planexec as jpe
    from repro_torch.core import planexec as tpe
    for P in range(0, 9):
        for bidir in (True, False):
            assert tpe.ring_hops(P, bidir) == jpe.ring_hops(P, bidir)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("n_pods", [2, 3, 4, 5, 8])
def test_chunk_grid_matches_reference(monkeypatch, n_pods, bidir):
    """ring_chunk_count per rung and exec_grid over random plans, with the
    port's constants set to the reference's."""
    from repro.core import planexec as jpe
    from repro.core.compression import Level as JLevel
    from repro_torch.core import planexec as tpe
    from repro_torch.core.compression import Level as TLevel
    for k, v in REF_CONSTANTS.items():
        monkeypatch.setattr(tpe, k, v)
    ladder = [("FULL", 1.0, 16), ("INT8", 1.0, 8), ("INT4", 1.0, 4),
              ("TOPK25_INT8", 0.25, 8), ("TOPK10_INT8", 0.10, 8),
              ("SIGN1", 1.0, 1), ("TOPK1_INT8", 0.01, 8), ("SKIP", 0.0, 0)]
    jl = [JLevel(*x) for x in ladder]
    tl = [TLevel(*x) for x in ladder]
    for j, t in zip(jl, tl):
        for nb in (0, 1, 2, 3, 7, 64, 1000, 4096, 20000, 50432, 98304,
                   196608, 294912, 443697):
            for ring in (None, -1, 0, 1, 2, 3, 16, 40):
                assert (tpe.ring_chunk_count(t, nb, n_pods, ring=ring,
                                             bidir=bidir)
                        == jpe.ring_chunk_count(j, nb, n_pods, ring=ring,
                                                bidir=bidir)), \
                    (t.name, nb, ring)
    r = np.random.RandomState(n_pods)
    for _ in range(20):
        idx = tuple(int(i) for i in r.randint(0, 8, size=11))
        sizes = tuple(int(s) for s in
                      np.exp(r.uniform(3, 19.5, size=11)).astype(np.int64))
        for growth in (None, 1.125):
            for ring in (None, -1, 2, 5):
                want = jpe.exec_grid(idx, sizes, jl, n_pods, growth=growth,
                                     ring=ring, bidir=bidir)
                got = tpe.exec_grid(idx, sizes, tl, n_pods, growth=growth,
                                    ring=ring, bidir=bidir)
                assert got == want, (idx, sizes, growth, ring)


# ---------------------------------------------------------------------------
# the port's pods: ring against one-shot
# ---------------------------------------------------------------------------


def _port_pod(group, n_pods, consts):
    """One pod: sync_tree under the one-shot, forced K and auto plans."""
    import torch
    from repro_torch.core import planexec
    from repro_torch.core import sync as S
    from repro_torch.core.compression import Level
    from repro_torch.core.scheduler import SyncPlan

    for k, v in consts.items():
        setattr(planexec, k, v)
    levels = tuple(Level(*x) for x in LEVELS)
    plan = SyncPlan(tuple(range(len(LEVELS))), levels, _omega(n_pods), 1)
    g, e = _inputs(n_pods)
    tree = {f"p{i}": torch.from_numpy(x[group.rank].copy())
            for i, x in enumerate(g)}
    errs = {f"p{i}": torch.from_numpy(x[group.rank].copy())
            for i, x in enumerate(e)}
    plans = {"one_shot": (-1, True), "k2": (2, True), "k3": (3, True),
             "auto": (None, True)}
    if n_pods == 4:
        plans["k2_unidir"] = (2, False)
    out = {}
    for name, (ring, bidir) in plans.items():
        ep = planexec.build_exec_plan(plan, SIZES, n_pods=n_pods, ring=ring,
                                      bidir=bidir, device="cpu")
        group.log.clear()
        agg, ne = S.sync_tree(tree, errs, ep, gamma=0.9, pods=group)
        want = sum(ep.levels[r].wire_bytes(s * 1024, n_pods)
                   for r, s in enumerate(ep.sig)
                   if s and ep.levels[r].codec.supports_ring)
        out[name] = {"agg": {k: v.numpy() for k, v in agg.items()},
                     "err": {k: v.numpy() for k, v in ne.items()},
                     "bytes": group.bytes_logged("gather")
                     + group.bytes_logged("ring"),
                     "want": want, "chunks": ep.chunks,
                     "hops": sum(1 for x in group.log if x["op"] == "ring")}
    return out


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """{P: [port result per pod]}, with the reference's ring running in
    subprocesses meanwhile: {P: npz path}."""
    from repro_torch.launch.mesh import spawn_pods
    tmp = tmp_path_factory.mktemp("ring")
    refs = {P: _run_reference(P, tmp / f"ref{P}.npz") for P in PODS}
    out = {}
    try:
        for P in PODS:
            out[P] = spawn_pods(_port_pod, P, "cpu",
                                args=(P, SMALL_CONSTANTS),
                                init_method=f"file://{tmp / f'store{P}'}",
                                threads=1, timeout=600)
        for P, proc in refs.items():
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    finally:
        for proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {P: (out[P], dict(np.load(tmp / f"ref{P}.npz"))) for P in PODS}


@pytest.mark.parametrize("n_pods", PODS)
def test_ring_equals_one_shot_on_every_pod(pods, n_pods):
    port, _ = pods[n_pods]
    for p, res in enumerate(port):
        one = res["one_shot"]
        for name, got in res.items():
            if name == "one_shot":
                assert not any(got["chunks"])
                continue
            assert any(got["chunks"]), name
            for k in one["agg"]:
                msg = f"{name} pod {p} {k}"
                np.testing.assert_array_equal(_bits(got["agg"][k]),
                                              _bits(one["agg"][k]), msg)
                np.testing.assert_array_equal(_bits(got["err"][k]),
                                              _bits(one["err"][k]), msg)
                np.testing.assert_array_equal(
                    _bits(got["agg"][k]), _bits(port[0][name]["agg"][k]),
                    msg + " (across pods)")


@pytest.mark.parametrize("n_pods", PODS)
def test_ring_bytes_equal_plan_wire_bytes(pods, n_pods):
    """Gather + ring bytes = plan_wire_bytes of the gather rungs (chunk
    padding included), and one ring log entry per (hop, chunk) of the
    critical path."""
    from repro_torch.core.planexec import ring_hops
    port, _ = pods[n_pods]
    for res in port:
        for name, got in res.items():
            assert got["bytes"] == got["want"] > 0, name
            bidir = name != "k2_unidir"
            assert got["hops"] == sum(got["chunks"]) * ring_hops(
                n_pods, bidir), name


# ---------------------------------------------------------------------------
# against the reference's ring
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import json, os, sys
P = int(sys.argv[1]); OUT = sys.argv[2]
LEVELS, SIZES = json.loads(sys.argv[3])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as Spec
from repro import compat
from repro.core import sync as S
from repro.core.compression import Level
from repro.core.planexec import build_exec_plan
from repro.core.scheduler import SyncPlan
from repro.launch.mesh import make_mesh

mesh = make_mesh((P, 1, 1), ("pod", "data", "model"))
levels = tuple(Level(*x) for x in LEVELS)
omega = tuple(float(x) for x in np.arange(1, P + 1) / (P * (P + 1) / 2))
plan = SyncPlan(tuple(range(len(levels))), levels, omega, 1)
r = np.random.RandomState(11)
g = [r.randn(P, n).astype(np.float32) for n in SIZES]
e = [(r.randn(P, n) * 0.3).astype(np.float32) for n in SIZES]
tree = {f"p{i}": jnp.asarray(x) for i, x in enumerate(g)}
errs = {f"p{i}": jnp.asarray(x) for i, x in enumerate(e)}
ep = build_exec_plan(plan, list(SIZES), n_pods=P, ring=2)
assert any(ep.chunks), ep.chunks

def inner(t, err):
    t = jax.tree.map(lambda x: x.reshape(x.shape[1:]), t)
    err = jax.tree.map(lambda x: x.reshape(x.shape[1:]), err)
    a, ne = S.sync_tree(t, err, ep, mesh=mesh, shardings=None, gamma=0.9,
                        inside_manual=True, use_pallas=True)
    return (jax.tree.map(lambda x: x[None], a),
            jax.tree.map(lambda x: x[None], ne))

pod = jax.tree.map(lambda _: Spec("pod"), tree)
fn = jax.jit(compat.shard_map(inner, mesh, in_specs=(pod, pod),
                              out_specs=(pod, pod),
                              manual_axes=set(mesh.axis_names)))
agg, ne = fn(tree, errs)
out = {}
for k in tree:
    out[f"agg/{k}"] = np.asarray(agg[k])
    out[f"err/{k}"] = np.asarray(ne[k])
np.savez(OUT, **out)
print("REF_OK")
"""


def _run_reference(n_pods, out_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_FORCE_INTERPRET="1")
    return subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(n_pods), str(out_path),
         json.dumps([LEVELS, SIZES])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _fold_bound(ef, omega):
    """Per-entry sum_p w_p * absmax_p(block) of the encoded values
    ``ef`` (P, n)."""
    pad = (-ef.shape[1]) % 1024
    blk = np.abs(np.pad(ef.astype(np.float64), ((0, 0), (0, pad)))) \
        .reshape(ef.shape[0], -1, 1024).max(axis=2)
    bound = (np.asarray(omega)[:, None] * blk).sum(axis=0)
    return np.repeat(bound, 1024)[:ef.shape[1]]


@pytest.mark.parametrize("n_pods", PODS)
def test_ring_matches_reference_ring(pods, n_pods):
    port, ref = pods[n_pods]
    g, e = _inputs(n_pods)
    omega = _omega(n_pods)
    for i in range(len(SIZES)):
        key = f"p{i}"
        ef = g[i] + 0.9 * e[i]
        for p in range(n_pods):
            for what in ("agg", "err"):
                got = port[p]["k2"][what][key]
                want = ref[f"{what}/{key}"][p]
                msg = f"{what} {LEVELS[i][0]} pod {p}"
                if i == SIGN_RUNG:
                    blk = np.abs(ref[f"agg/{key}"][p]).max()
                    tol = (SIGN_ULP * np.spacing(np.float32(blk))
                           + (n_pods * 2.0 ** -16 if n_pods >= 3 else 0.0))
                    assert np.abs(got - want).max() <= tol, msg
                elif (what == "agg" and n_pods == 2
                      and i in (INT8_RUNG, INT4_RUNG)):
                    tol = 2 * np.spacing(
                        _fold_bound(ef, omega).astype(np.float32))
                    assert np.all(np.abs(got - want) <= tol), msg
                else:
                    np.testing.assert_array_equal(_bits(got), _bits(want),
                                                  msg)


def test_p2_ring_is_the_same_on_both_pods(pods, capsys):
    """ROADMAP R3: the reference's P = 2 ring folds each pod's own payload
    first, so its two pods' INT8 / INT4 aggregates can differ in the last
    bit; the port folds in pod order and its pods agree bit for bit (the
    count of the reference's differing entries is printed)."""
    port, ref = pods[2]
    differ = 0
    for i in (INT8_RUNG, INT4_RUNG):
        key = f"p{i}"
        a = ref[f"agg/{key}"]
        differ += int((_bits(a[0]) != _bits(a[1])).sum())
        np.testing.assert_array_equal(_bits(port[0]["k2"]["agg"][key]),
                                      _bits(port[1]["k2"]["agg"][key]))
    with capsys.disabled():
        print(f"\nreference P = 2 ring: {differ} of "
              f"{SIZES[INT8_RUNG] + SIZES[INT4_RUNG]} INT8 / INT4 aggregate "
              f"entries differ between its pods; the port's: 0")
