"""Pods x ("data", "model"): the sync round on each rank of P pods of D x M
meshes against the live reference's, the divergence estimate on a fleet
of meshes, and the refusals that remain.

The reference runs ``sync_tree`` in a subprocess on six forced XLA host
devices, under a ``shard_map`` manual over ("pod", "data", "model"), as
its trainer's nested manual region runs it (``inside_manual``, its
interpreted kernels: ``use_pallas`` / ``REPRO_FORCE_INTERPRET=1``):
every device holds its own seeded leaves (one per rung of the ladder,
not all block multiples) and residuals, and its pod collectives join the
devices with its (d, m).  Its multi-pod *trainer* aborts on such meshes
on the CPU (ROADMAP R1); its sync round runs.  The port runs one gloo
process per rank (``spawn_fleet_mesh``, ``file://`` rendezvous; rank code
in ``tests/torch_fleet_mesh_ranks.py``), each rank's round over the pod
group of its (d, m).  Checked, on (2, 1, 2) and (2, 2, 1) under the
one-shot exchange and the ring forced to 2 chunks, and on (3, 1, 2)
one-shot (the int32 fixed-point folds):

* every device's aggregate and residual bit for bit the reference's,
  with the exceptions of tests/test_torch_ring.py: SIGN1's block scale is
  summed in another order (8 ulp of the scale, plus one fixed-point unit
  per pod at P >= 3), and the INT8 / INT4 aggregates at P = 2 within 2
  ulp of sum_p w_p * absmax_p of their block: the reference's ring folds
  each pod's own payload first (ROADMAP R3), and its one-shot fold
  inside the manual region is contracted the other way round, as inside
  its jitted trainer (tests/test_torch_multipod.py's bound);
* the port's aggregate bit-identical on every pod of a (d, m);
* the bytes each (d, m)'s pod group moved: gather + ring equal to
  ``plan_wire_bytes`` of the payload rungs, FULL's within its shard
  padding of ``FullCodec.wire_bytes``.

The divergence (eq. 9's D_k) of SMOKE paper-350m with parameters drawn
per pod: identical on every rank of a pod, and within ``DIV_RTOL`` =
1e-6 relative of the estimate with one card per pod (the order of f32
sums differs).
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_fleet_mesh_ranks as R

ROOT = Path(__file__).resolve().parents[1]
#: (P, D, M) -> the exec plans run there
CASES = {(2, 1, 2): ("one_shot", "k2"), (2, 2, 1): ("one_shot", "k2"),
         (3, 1, 2): ("one_shot",)}
#: the ladder's rungs (``ACESyncConfig``'s, leaf i on rung i)
INT8_RUNG, INT4_RUNG, SIGN_RUNG = 1, 2, 5
SIGN_ULP = 8
DIV_RTOL = 1e-6

REF_SCRIPT = r"""
import json, os, sys
CASES, SIZES, GAMMA, OUT = json.loads(sys.argv[1])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as Spec
from repro import compat
from repro.configs.base import ACESyncConfig
from repro.core import sync as S
from repro.core.planexec import build_exec_plan
from repro.core.scheduler import Scheduler
from repro.launch.mesh import make_mesh

RINGS = {"one_shot": 0, "k2": 2}
for (P, D, M), names in CASES:
    n = P * D * M
    mesh = make_mesh((P, D, M), ("pod", "data", "model"),
                     devices=jax.devices()[:n])
    omega = tuple(float(x) for x in np.arange(1, P + 1) / (P * (P + 1) / 2))
    plan = Scheduler(ACESyncConfig(), list(SIZES), P).plan_from_levels(
        list(range(len(SIZES))), omega)
    r = np.random.RandomState(11)
    g = [r.randn(n, k).astype(np.float32) for k in SIZES]
    e = [(r.randn(n, k) * 0.3).astype(np.float32) for k in SIZES]
    tree = {f"p{i}": jnp.asarray(x) for i, x in enumerate(g)}
    errs = {f"p{i}": jnp.asarray(x) for i, x in enumerate(e)}
    spec = jax.tree.map(lambda _: Spec(("pod", "data", "model")), tree)
    out = {}
    for name in names:
        ep = build_exec_plan(plan, list(SIZES), n_pods=P, ring=RINGS[name])

        def inner(t, err, ep=ep):
            t = jax.tree.map(lambda x: x.reshape(x.shape[1:]), t)
            err = jax.tree.map(lambda x: x.reshape(x.shape[1:]), err)
            a, ne = S.sync_tree(t, err, ep, mesh=mesh, shardings=None,
                                gamma=GAMMA, inside_manual=True,
                                use_pallas=True)
            return (jax.tree.map(lambda x: x[None], a),
                    jax.tree.map(lambda x: x[None], ne))

        fn = jax.jit(compat.shard_map(inner, mesh, in_specs=(spec, spec),
                                      out_specs=(spec, spec),
                                      manual_axes=set(mesh.axis_names)))
        agg, ne = fn(tree, errs)
        for k in tree:
            out[f"{name}/agg/{k}"] = np.asarray(agg[k])
            out[f"{name}/err/{k}"] = np.asarray(ne[k])
        out[f"{name}/chunks"] = np.asarray(ep.chunks)
    np.savez(os.path.join(OUT, f"ref_{P}{D}{M}.npz"), **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """{(P, D, M): ([the port's result per rank], the reference's npz)},
    and the divergence with one card per pod: the reference's subprocess
    runs while the port's ranks do."""
    from repro_torch.launch.mesh import spawn_fleet_mesh, spawn_pods
    tmp = tmp_path_factory.mktemp("fleet_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_FORCE_INTERPRET="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT,
         json.dumps([[[list(k), list(v)] for k, v in CASES.items()],
                     list(R.SIZES), R.GAMMA, str(tmp)])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    try:
        for (P, D, M), names in CASES.items():
            port[(P, D, M)] = spawn_fleet_mesh(
                R.sync_rank, P, D, M, "cpu",
                args=({k: R.RINGS[k] for k in names}, P == 2),
                init_method=f"file://{tmp / f'store{P}{D}{M}'}", threads=1,
                timeout=600)
        one_card = spawn_pods(R.divergence_pod, 2, "cpu", threads=1,
                              init_method=f"file://{tmp / 'store_one'}",
                              timeout=600)
        so, se = proc.communicate(timeout=900)
        assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = {k: (v, dict(np.load(tmp / f"ref_{k[0]}{k[1]}{k[2]}.npz")))
           for k, v in port.items()}
    return out, one_card


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _fold_bound(ef, omega):
    """Per-entry sum_p w_p * absmax_p(block) of the encoded values
    ``ef`` (P, n)."""
    pad = (-ef.shape[1]) % 1024
    blk = np.abs(np.pad(ef.astype(np.float64), ((0, 0), (0, pad)))) \
        .reshape(ef.shape[0], -1, 1024).max(axis=2)
    bound = (np.asarray(omega)[:, None] * blk).sum(axis=0)
    return np.repeat(bound, 1024)[:ef.shape[1]]


CASE_IDS = [(k, name) for k, names in CASES.items() for name in names]


@pytest.mark.parametrize("mesh,plan", CASE_IDS,
                         ids=[f"{'x'.join(map(str, k))}-{n}"
                              for k, n in CASE_IDS])
def test_round_on_each_rank_is_the_references(fleets, mesh, plan):
    port, ref = fleets[0][mesh]
    P, D, M = mesh
    n = D * M
    g, e = R.sync_inputs(P * n)
    omega = R.omega(P)
    assert (list(port[0]["rounds"][plan]["chunks"])
            == ref[f"{plan}/chunks"].tolist())
    assert any(port[0]["rounds"][plan]["chunks"]) == (plan == "k2")
    for res in port:
        w = res["world"]
        p = w // n
        assert res["coords"] == (p, (w % n) // M, w % M)
        got = res["rounds"][plan]
        for i in range(len(R.SIZES)):
            key = f"p{i}"
            for what in ("agg", "err"):
                have = got[what][key]
                want = ref[f"{plan}/{what}/{key}"][w]
                msg = f"{what} rung {i} device {w} ({plan})"
                if i == SIGN_RUNG:
                    blk = np.abs(ref[f"{plan}/agg/{key}"][w]).max()
                    tol = (SIGN_ULP * np.spacing(np.float32(blk))
                           + (P * 2.0 ** -16 if P >= 3 else 0.0))
                    assert np.abs(have - want).max() <= tol, msg
                elif (what == "agg" and P == 2
                      and i in (INT8_RUNG, INT4_RUNG)):
                    cell = [q * n + w % n for q in range(P)]
                    ef = g[i][cell] + R.GAMMA * e[i][cell]
                    tol = 2 * np.spacing(
                        _fold_bound(ef, omega).astype(np.float32))
                    assert np.all(np.abs(have - want) <= tol), msg
                else:
                    np.testing.assert_array_equal(_bits(have), _bits(want),
                                                  msg)


@pytest.mark.parametrize("mesh,plan", CASE_IDS,
                         ids=[f"{'x'.join(map(str, k))}-{n}"
                              for k, n in CASE_IDS])
def test_aggregate_is_the_same_on_every_pod_of_a_cell(fleets, mesh, plan):
    port, _ = fleets[0][mesh]
    n = mesh[1] * mesh[2]
    for res in port:
        first = port[res["world"] % n]["rounds"][plan]["agg"]
        for k, v in res["rounds"][plan]["agg"].items():
            np.testing.assert_array_equal(_bits(v), _bits(first[k]), k)


@pytest.mark.parametrize("mesh,plan", CASE_IDS,
                         ids=[f"{'x'.join(map(str, k))}-{n}"
                              for k, n in CASE_IDS])
def test_each_cells_bytes_are_the_priced_ones(fleets, mesh, plan):
    port, _ = fleets[0][mesh]
    for res in port:
        (pay_got, full_got), (pay, full, pad) = (
            res["rounds"][plan]["logged"], res["rounds"][plan]["priced"])
        assert pay_got == pay > 0
        assert full_got == full or 0 <= full_got - full < pad


@pytest.mark.parametrize("mesh", [(2, 1, 2), (2, 2, 1)],
                         ids=["2x1x2", "2x2x1"])
def test_divergence_is_the_same_on_every_rank_of_a_pod(fleets, mesh):
    port, _ = fleets[0][mesh]
    one_card = fleets[1]
    n = mesh[1] * mesh[2]
    for res in port:
        p = res["world"] // n
        assert res["divergence"] == port[p * n]["divergence"]
        assert res["divergence"] > 0
        assert abs(res["divergence"] - one_card[p]) <= \
            DIV_RTOL * abs(one_card[p]), (res["divergence"], one_card[p])


def test_divergence_without_a_mesh_is_unchanged():
    """Without a mesh the estimate projects the whole leaves as before:
    the mesh form's samples and signs on a rank holding every leaf whole
    give the same projection."""
    import torch
    from repro_torch.core import divergence as Dv
    r = np.random.RandomState(3)
    params = {"a": torch.from_numpy(r.randn(70000).astype(np.float32)),
              "b": torch.from_numpy(r.randn(3, 700).astype(np.float32))}
    whole = Dv.project_params(params)
    shards = [((70000,), (slice(None),)),
              ((3, 700), (slice(None), slice(None)))]
    meshed = Dv.project_params(params, shards=shards, reduce=lambda x: x)
    np.testing.assert_allclose(meshed.numpy(), whole.numpy(), rtol=1e-6)
    # a shard's part: the halves of "b" along its columns add up
    halves = [((3, 700), (slice(None), slice(0, 350))),
              ((3, 700), (slice(None), slice(350, 700)))]
    parts = [Dv._shard_projections(params["b"][:, s[1][1]], *s, 5, 8)
             for s in halves]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(),
                               Dv._leaf_projections(params["b"], 5,
                                                    8).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_two_tier_fleets_of_meshes_are_refused(tmp_path, capsys):
    """A two-tier fleet (``n_edge`` > 1) of ("data", "model") meshes
    trains since ROADMAP Queue 1 item 3b: the Trainer of a mesh model
    builds on it with its scheduler hierarchical (C = 2 clusters x E = 2
    members); what the train CLI still refuses is a fleet that does not
    split into clusters (tests/test_torch_fleet_hier_mesh*.py run it)."""
    from repro_torch.core.trainer import Trainer
    from repro_torch.launch import train
    from repro_torch.models import shardctx as SC
    from repro_torch.models.registry import build_model
    run = R.run_config("paper-350m", 2)
    model = build_model(run.model, run, device="cpu", ctx=SC.ShardCtx(1, 2))
    two_tier = type("Pods", (), {"size": 4, "n_edge": 2})()
    tr = Trainer(model, run, pods=two_tier)
    assert (tr.n_pods, tr.n_edge) == (4, 2)
    assert tr.scheduler.hier_enabled and tr.scheduler.n_cross == 2
    with pytest.raises(SystemExit):
        train.main(["--pods", "3", "--edge", "2", "--data", "1", "--model",
                    "2", "--smoke", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path)])
    assert "clusters of --edge 2" in capsys.readouterr().err
