"""A two-tier fleet of ("data", "model") meshes: the sync round on each
rank of C clusters x E members, each member a D x M mesh, against the
live reference's.

The reference runs ``sync_tree`` in a subprocess on eight forced XLA host
devices, under a ``shard_map`` manual over ("pod", "edge", "data",
"model"), as its trainer's nested manual region runs it
(``inside_manual``, its interpreted kernels: ``use_pallas`` /
``REPRO_FORCE_INTERPRET=1``): every device holds its own seeded leaves
(one per rung, not all block multiples) and residuals; its two-tier
rungs exchange over "edge" and "pod" at the device's (d, m), its flat
rungs over ("pod", "edge").  Its multi-pod *trainer* aborts on such
meshes on the CPU (ROADMAP R1); its sync round runs.  The port runs one
gloo process per rank (``spawn_fleet_mesh(..., n_edge=2)``, ``file://``
rendezvous; rank code in ``tests/torch_fleet_hier_mesh_ranks.py``), each
rank's round over the fleet group of its (d, m) and that group's
``intra`` and ``cross`` sub-groups.  On (2, 2, 1, 2) and (2, 2, 2, 1),
the plan INT8 / TOPK10 / SIGN1 / INT4 / FULL / SKIP with INT8 and INT4
two-tier at either intra stage (``hier`` 1: bf16 sum, 2: INT8), the
cross tier one-shot and a K = 2 ring, checked with the bounds of
tests/test_torch_hier.py:

* every residual and the flat rungs' aggregates (TOPK10, FULL, SKIP over
  the four members) bit for bit the reference's; SIGN1's within 8 ulp of
  its block scale plus one fixed-point unit per member (its scale is
  summed in another order); the two-tier rungs' aggregates within 2 ulp
  of sum_c absmax_c of the cluster aggregates' blocks (the reference's
  cross fold contracts its unit weights, ROADMAP R4; its ring folds each
  cluster's own payload first, R3);
* the cross tier's ring bit-identical to its one-shot on every rank;
* the aggregate bit-identical on the four members of a (d, m);
* the bytes each (d, m)'s groups received: the fleet group's and the
  cross sub-group's equal to ``sig_wire_bytes`` of the local layout with
  the tier grid at the cluster count, the intra sub-group's to
  ``sig_intra_bytes``;
* rank (c, e, d, m) at world rank (c * E + e) * D * M + d * M + m, rank
  e of its cluster's intra group and rank c of its cross group.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_fleet_hier_mesh_ranks as R

ROOT = Path(__file__).resolve().parents[1]
C, E = 2, 2
MESHES = ((1, 2), (2, 1))
SIGN_RUNG = 2
SIGN_ULP = 8

REF_SCRIPT = r"""
import json, os, sys
MESHES, C, E, LEVELS, SIZES, MODES, RINGS, GAMMA, OUT = json.loads(
    sys.argv[1])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as Spec
from repro import compat
from repro.core import sync as S
from repro.core.compression import Level
from repro.core.planexec import build_exec_plan
from repro.core.scheduler import SyncPlan
from repro.launch.mesh import make_mesh

F = C * E
levels = tuple(Level(*x) for x in LEVELS)
om = np.arange(1, F + 1) / (F * (F + 1) / 2)
plan = SyncPlan(tuple(range(len(levels))), levels, tuple(om), 1)
for D, M in MESHES:
    n = F * D * M
    axes = ("pod", "edge", "data", "model")
    mesh = make_mesh((C, E, D, M), axes, devices=jax.devices()[:n])
    r = np.random.RandomState(11)
    g = [r.randn(n, k).astype(np.float32) for k in SIZES]
    e = [(r.randn(n, k) * 0.3).astype(np.float32) for k in SIZES]
    tree = {f"p{i}": jnp.asarray(x) for i, x in enumerate(g)}
    errs = {f"p{i}": jnp.asarray(x) for i, x in enumerate(e)}
    spec = jax.tree.map(lambda _: Spec(axes), tree)
    out = {}
    for mode in MODES:
        for ring in RINGS:
            ep = build_exec_plan(plan, list(SIZES), n_pods=F, n_edge=E,
                                 hier=mode, ring=ring)

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
                                          manual_axes=set(axes)))
            agg, ne = fn(tree, errs)
            for k in tree:
                out[f"{mode}/{ring}/agg/{k}"] = np.asarray(agg[k])
                out[f"{mode}/{ring}/err/{k}"] = np.asarray(ne[k])
            out[f"{mode}/{ring}/hier"] = np.asarray(ep.hier)
            out[f"{mode}/{ring}/chunks"] = np.asarray(ep.chunks)
    np.savez(os.path.join(OUT, f"ref_{D}{M}.npz"), **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """{(D, M): ([the port's result per rank], the reference's npz)}: the
    reference's subprocess runs while the port's ranks do."""
    from repro_torch.launch.mesh import spawn_fleet_mesh
    tmp = tmp_path_factory.mktemp("fleet_hier_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_FORCE_INTERPRET="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT,
         json.dumps([MESHES, C, E, R.LEVELS, R.SIZES, R.MODES, R.RINGS,
                     R.GAMMA, str(tmp)])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    try:
        for D, M in MESHES:
            port[(D, M)] = spawn_fleet_mesh(
                R.sync_rank, C * E, D, M, "cpu", n_edge=E,
                init_method=f"file://{tmp / f'store{D}{M}'}", threads=1,
                timeout=600)
        so, se = proc.communicate(timeout=900)
        assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {k: (v, dict(np.load(tmp / f"ref_{k[0]}{k[1]}.npz")))
            for k, v in port.items()}


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _cluster_bound(aggs):
    """Per-entry 2 ulp of sum_c absmax_c(block) of the cluster aggregates
    ``aggs`` (C, n) that the cross tier re-encodes (unit weights)."""
    aggs = np.asarray(aggs, np.float64)
    pad = (-aggs.shape[1]) % 1024
    blk = np.abs(np.pad(aggs, ((0, 0), (0, pad)))).reshape(
        aggs.shape[0], -1, 1024).max(axis=2).sum(axis=0)
    return 2 * np.spacing(np.repeat(blk, 1024)[:aggs.shape[1]]
                          .astype(np.float32))


CASES = [(mesh, mode, ring) for mesh in MESHES for mode in R.MODES
         for ring in R.RINGS]
IDS = [f"2x2x{d}x{m}-intra{mode}-{'ring2' if ring > 0 else 'one_shot'}"
       for (d, m), mode, ring in CASES]


@pytest.mark.parametrize("mesh,mode,ring", CASES, ids=IDS)
def test_round_on_each_rank_is_the_references(fleets, mesh, mode, ring):
    port, ref = fleets[mesh]
    n = mesh[0] * mesh[1]
    tag = f"{mode}/{ring}"
    first = port[0]["rounds"][(mode, ring)]
    assert first["hier"] == ref[f"{tag}/hier"].tolist()
    assert first["hier"][:4] == [mode, 0, 0, mode]
    assert first["chunks"] == ref[f"{tag}/chunks"].tolist()
    assert (first["chunks"][0] == 2) == (ring == 2)
    for res in port:
        w = res["world"]
        got = res["rounds"][(mode, ring)]
        for i in range(len(R.SIZES)):
            key = f"p{i}"
            for what in ("agg", "err"):
                have = got[what][key]
                want = ref[f"{tag}/{what}/{key}"][w]
                msg = f"{what} {R.LEVELS[i][0]} device {w}"
                if i == SIGN_RUNG:
                    blk = np.abs(ref[f"{tag}/agg/{key}"][w]).max()
                    tol = (SIGN_ULP * np.spacing(np.float32(blk))
                           + C * E * 2.0 ** -16)
                    assert np.abs(have - want).max() <= tol, msg
                elif what == "agg" and i in R.TWO_TIER_RUNGS:
                    # one member per cluster at this rank's (d, m)
                    cells = [port[c * E * n + w % n] for c in range(C)]
                    tol = _cluster_bound([q["agg_c"][(mode, i)]
                                          for q in cells])
                    assert np.all(np.abs(have - want) <= tol), msg
                else:
                    np.testing.assert_array_equal(_bits(have), _bits(want),
                                                  msg)


@pytest.mark.parametrize("mesh,mode,ring", CASES, ids=IDS)
def test_aggregate_is_the_same_on_every_member_of_a_cell(fleets, mesh, mode,
                                                         ring):
    """The four members at one (d, m) hold the same aggregate, and the
    cross tier's ring gives every rank its one-shot's bits."""
    port, _ = fleets[mesh]
    n = mesh[0] * mesh[1]
    for res in port:
        got = res["rounds"][(mode, ring)]
        first = port[res["world"] % n]["rounds"][(mode, ring)]["agg"]
        one = res["rounds"][(mode, -1)]
        for k, v in got["agg"].items():
            np.testing.assert_array_equal(_bits(v), _bits(first[k]), k)
            for what in ("agg", "err"):
                np.testing.assert_array_equal(_bits(got[what][k]),
                                              _bits(one[what][k]), k)


@pytest.mark.parametrize("mesh,mode,ring", CASES, ids=IDS)
def test_each_cells_tier_bytes_are_the_priced_ones(fleets, mesh, mode, ring):
    port, _ = fleets[mesh]
    for res in port:
        got = res["rounds"][(mode, ring)]
        assert tuple(got["bytes"]) == tuple(got["priced"])
        assert min(got["priced"]) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2x1x2", "2x2x2x1"])
def test_ranks_sit_at_the_references_fleet_slots(fleets, mesh):
    port, _ = fleets[mesh]
    D, M = mesh
    for w, res in enumerate(port):
        p, cell = divmod(w, D * M)
        assert res["world"] == w
        assert res["coords"] == (p, cell // M, cell % M)
        assert res["slot"] == (p // E, p % E, p // E)
