"""The dry run (``repro_torch/launch/dryrun.py``) against the reference's,
on the CPU.

* ``cells()`` and ``LONG_CONTEXT_ARCHS`` are the reference's.
* Every cell on both production meshes (16 x 16 and 2 x 16 x 16), train
  cells under ``acesync``: the reference builds its ``Trainer`` on 512
  forced XLA host devices in one subprocess, lowering and compiling
  nothing; the port builds rank (0, 0)'s model, Trainer and state on the
  meta device with dry groups.  Equal: the default plan's level names,
  its ``bucket_sig`` (the port's ring constants set to the reference's,
  as ``tests/test_torch_ring.py`` sets them: the grid's chunk rounding
  follows them), the per-device state bytes (the largest rank's; serving:
  bf16 parameter bytes) and ``model_flops_global``.
* On meta every kernel wrapper gives its plain version's output shapes
  and dtypes, records its rows and bytes by the kernels' table and builds
  nothing; the dry groups log every collective by ``PodGroup``'s rule.
* The CLI writes its records and prints the reference's two lines; the
  sweep resumes from ``ok`` records; importing the dry run loads no JAX.

The traced cells, and the counts held to the port's real gloo ranks, are
in ``tests/test_torch_dryrun_trace.py``.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import LONG_CONTEXT_ARCHS, cells
from repro_torch.core import planexec as tpe
from repro_torch.kernels import ops, ref, table
from repro_torch.launch import dryrun, sweep
from repro_torch.launch.dry import DryGroup, dry_layout
from repro_torch.launch.mesh import PodGroup, received_bytes
from test_torch_ring import REF_CONSTANTS

ROOT = Path(__file__).resolve().parents[1]
MESHES = {False: "16x16", True: "2x16x16"}
CASES = [(mp, a, s) for mp in (False, True) for a, s in cells()]

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import numpy as np
import jax
from repro.configs import ARCHS, SHAPES, LONG_CONTEXT_ARCHS, cells
from repro.configs.base import RunConfig
from repro.core.trainer import Trainer
from repro.launch import mesh as mesh_lib
from repro.models.registry import build_model
from repro.models.flops import model_flops
from repro.models.shardctx import sharding_for

out = {"cells": cells(), "cells_all": cells(include_long_skips=True),
       "long": sorted(LONG_CONTEXT_ARCHS), "records": {}}
isP = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731


def shard_bytes(specs, shardings, itemsize=None):
    return sum(int(np.prod(sh.shard_shape(sp.shape)))
               * (itemsize or np.dtype(sp.dtype).itemsize)
               for sp, sh in zip(jax.tree.leaves(specs),
                                 jax.tree.leaves(shardings)))


for mp, name in ((False, "16x16"), (True, "2x16x16")):
    mesh = mesh_lib.make_production_mesh(multi_pod=mp)
    for arch, shape_name in cells():
        cfg, shape = ARCHS[arch], SHAPES[shape_name]
        run = RunConfig(model=cfg, shape=shape, multi_pod=mp)
        model = build_model(cfg, run)
        rec = {"model_flops_global": model_flops(cfg, shape)}
        if shape.kind == "train":
            tr = Trainer(model, run, mesh=mesh, strategy="acesync")
            plan = tr.default_plan(bandwidth_mbps=50.0)
            rec.update(plan=[plan.levels[i].name for i in plan.level_idx],
                       bucket_sig=list(plan.bucket_sig or ()),
                       state_bytes=shard_bytes(tr.state_specs(),
                                               tr.state_shardings()))
        else:
            specs = model.param_specs()
            shards = jax.tree.map(
                lambda sp, s: sharding_for(mesh, sp, shape=s.shape),
                model.param_shardings(), specs, is_leaf=isP)
            rec["state_bytes"] = shard_bytes(specs, shards, 2)
        out["records"][f"{name}/{arch}/{shape_name}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_are_the_references(reference):
    assert [list(c) for c in cells()] == reference["cells"]
    assert [list(c) for c in cells(include_long_skips=True)] == \
        reference["cells_all"]
    assert sorted(LONG_CONTEXT_ARCHS) == reference["long"]
    assert len(cells()) == 32


@pytest.mark.parametrize("multi_pod,arch,shape", CASES,
                         ids=[f"{MESHES[m]}-{a}-{s}" for m, a, s in CASES])
def test_cell_counts_match_reference(reference, monkeypatch, multi_pod,
                                     arch, shape):
    """The plan, bucket_sig, per-device state bytes and model FLOPs of a
    cell, counted without tracing a step."""
    for k, v in REF_CONSTANTS.items():
        monkeypatch.setattr(tpe, k, v)
    rec = dryrun.dry_cell(arch, shape, multi_pod=multi_pod, trace=False)
    assert rec["ok"], rec.get("traceback")
    want = reference["records"][f"{MESHES[multi_pod]}/{arch}/{shape}"]
    assert rec["mesh"] == MESHES[multi_pod]
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["state_bytes_per_rank"]["max"] == want["state_bytes"]
    assert rec["model_flops_global"] == want["model_flops_global"]
    if "plan" in want:
        assert rec["plan"] == want["plan"]
        assert rec["bucket_sig"] == want["bucket_sig"]


# ---- the kernel wrappers on meta ------------------------------------------

LANES = ops.LANES


def _wrapper_cases(dev):
    """(name, wrapper call, plain call) of every kernel on ``dev``: each
    wrapper on the inputs its plain version takes."""
    g = torch.Generator().manual_seed(0)
    nb = 5

    def t(*shape, dtype=torch.float32):
        x = torch.randn(shape, generator=g)
        return (x if dtype == torch.float32 else
                x.mul(40).to(dtype)).to(dev)
    fb, eb = t(nb + 1, LANES), t(nb + 1, LANES)
    perm = torch.tensor([0, 3, 5], dtype=torch.int32).to(dev)
    acc, s, w = t(nb, LANES), t(nb).abs(), t(1)
    q8 = torch.randint(-127, 128, (nb, LANES), generator=g,
                       dtype=torch.int8).to(dev)
    p4 = torch.randint(0, 256, (nb, LANES // 2), generator=g,
                       dtype=torch.int32).to(torch.uint8).to(dev)
    p1 = torch.randint(0, 256, (nb, LANES // 8), generator=g,
                       dtype=torch.int32).to(torch.uint8).to(dev)
    k = 16
    idx = torch.stack([torch.randperm(LANES, generator=g)[:k]
                       for _ in range(nb)]).to(torch.uint16).to(dev)
    qk = torch.randint(-127, 128, (nb, k), generator=g,
                       dtype=torch.int8).to(dev)
    iacc = torch.randint(-1000, 1000, (nb, LANES), generator=g,
                         dtype=torch.int32).to(dev)
    imag = torch.randint(-1000, 1000, (nb,), generator=g,
                         dtype=torch.int32).to(dev)
    x = t(3 * LANES + 17)
    e = t(3 * LANES + 17)
    return [
        ("gather_ef_int8", lambda: ops.gather_ef_int8(fb, eb, perm,
                                                      gamma=0.9)),
        ("gather_ef_int4", lambda: ops.gather_ef_int4(fb, eb, perm,
                                                      gamma=0.9)),
        ("gather_ef_sign", lambda: ops.gather_ef_sign(fb, eb, perm,
                                                      gamma=0.9)),
        ("gather_ef_topk", lambda: ops.gather_ef_topk(fb, eb, perm,
                                                      gamma=0.9, k=k)),
        ("decode_accum_int8", lambda: ops.decode_accum_int8(acc, q8, s, w)),
        ("decode_accum_int4", lambda: ops.decode_accum_int4(acc, p4, s, w)),
        ("sign_vote_accum", lambda: ops.sign_vote_accum(acc, s, p1, s, w)),
        ("topk_scatter_accum",
         lambda: ops.topk_scatter_accum(acc, qk, idx, s, w)),
        ("decode_accum_int8_fp", lambda: ops.decode_accum_int8(
            iacc, q8, s, w, fixed_bits=16)),
        ("decode_accum_int4_fp", lambda: ops.decode_accum_int4(
            iacc, p4, s, w, fixed_bits=16)),
        ("sign_vote_accum_fp", lambda: ops.sign_vote_accum(
            iacc, imag, p1, s, w, fixed_bits=16)),
        ("quantize_int8", lambda: ops.quantize_int8(x)),
        ("ef_int4", lambda: ops.ef_int4(x, e, gamma=0.9)),
        ("ef_sign", lambda: ops.ef_sign(x, e, gamma=0.9)),
        ("ef_topk", lambda: ops.ef_topk(x, e, gamma=0.9, k=k)),
        ("dequant_int8", lambda: ops.dequant_int8(q8, s, 3 * LANES)),
    ]


def _shapes(out):
    return [(tuple(o.shape), o.dtype) if isinstance(o, torch.Tensor)
            else o for o in (out if isinstance(out, tuple) else (out,))]


#: the rows each case above launches over
ROWS = {"gather_ef_int8": 3, "gather_ef_int4": 3, "gather_ef_sign": 3,
        "gather_ef_topk": 3, "quantize_int8": 4, "ef_int4": 4, "ef_sign": 4,
        "ef_topk": 4, "dequant_int8": 5}


@pytest.mark.parametrize("i", range(len(ops.KERNELS)),
                         ids=list(ops.KERNELS))
def test_meta_wrappers_shape_like_the_plain_versions(i, monkeypatch):
    """On meta each wrapper returns its plain version's shapes and dtypes,
    records one launch (its rows, bytes by the table) and neither builds
    nor launches: ``build.load`` would raise here."""
    from repro_torch.kernels import build

    def no_build():
        raise AssertionError("a meta wrapper built the kernels")
    monkeypatch.setattr(build, "load", no_build)
    name, call = _wrapper_cases(torch.device("cpu"))[i]
    assert name == ops.KERNELS[i]
    want = _shapes(call())
    _, meta_call = _wrapper_cases(torch.device("meta"))[i]
    n0, before = len(ops.DRY_LAUNCHES), ops.launch_counts()
    try:
        got = meta_call()
        rec = ops.DRY_LAUNCHES[n0:]
    finally:
        del ops.DRY_LAUNCHES[n0:]
    assert _shapes(got) == want
    assert ops.launch_counts() == before
    rows = ROWS.get(name, 5)
    k = 16 if name == "topk_scatter_accum" else None
    assert rec == [(name, rows, rows * table.row_bytes(name, k))]


def test_row_bytes_are_the_tables():
    """The per-row bytes the dry run records are the table's that
    chip_smoke.py reckons its kernels' bounds from."""
    for name, (_, wbytes, _) in table.KERNELS.items():
        assert table.row_bytes(name) == 2 * LANES * 4 + 4 + wbytes
    for name, (_, nbytes) in table.DECODE.items():
        assert table.row_bytes(name) == nbytes
    for name, (_, nbytes, _) in table.FLAT.items():
        assert table.row_bytes(name) == nbytes
    assert table.row_bytes("topk_scatter_accum", table.TOPK_K) == \
        table.DECODE["topk_scatter_accum"][1]
    assert set(table.KERNELS) | set(table.DECODE) | set(table.FLAT) == \
        set(ops.KERNELS)
    assert ref.LANES == table.LANES


# ---- the dry groups -------------------------------------------------------

COLLECTIVES = {
    "all_gather": lambda g, x: g.all_gather(x),
    "all_gather_bytes": lambda g, x: g.all_gather_bytes(
        x.view(torch.uint8).reshape(-1)),
    "all_to_all": lambda g, x: g.all_to_all(x.reshape(g.size, -1)),
    "all_reduce_sum": lambda g, x: g.all_reduce_sum(x),
    "pmean": lambda g, x: g.pmean(x),
    "reduce_scatter": lambda g, x: g.reduce_scatter(x.reshape(g.size, -1)),
    "full_exchange": lambda g, x: g.full_exchange(
        x[:-3].to(torch.bfloat16)),
}


class _Loopback(PodGroup):
    """A one-process stand-in for a gloo member: every member sends what
    this one sends."""

    def _gather_flat(self, u8):
        return u8.reshape(1, -1).expand(self.size, -1).clone()

    def _scatter_flat(self, u8):
        return u8.reshape(self.size, -1).clone()


@pytest.mark.parametrize("op", sorted(COLLECTIVES))
@pytest.mark.parametrize("size", (2, 3, 16))
def test_dry_group_logs_by_the_pod_groups_rule(op, size):
    """A dry group's collective gives the real one's output shape and
    dtype on meta and logs the same (op, tier, bytes) entries as a
    ``PodGroup`` member, whose rule is ``received_bytes``."""
    x = torch.randn(size * 24)
    real = _Loopback(1, size, "cpu", "gloo", tier="model")
    dry = DryGroup(1, size, tier="model")
    want = COLLECTIVES[op](real, x)
    got = COLLECTIVES[op](dry, x.to("meta"))
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert got.device.type == "meta"
    strip = [{k: e[k] for k in ("op", "tier", "bytes")} for e in real.log]
    assert strip == [{k: e[k] for k in ("op", "tier", "bytes")}
                     for e in dry.log]
    assert received_bytes(size, 8 * size, scatter=True) == 8 * (size - 1)


def test_dry_ring_hop_logs_the_received_bytes():
    g = DryGroup(0, 4, tier="pod")
    fwd, bwd = g.ring_hop(torch.empty(40, dtype=torch.uint8, device="meta"),
                          None, tag=3).wait()
    assert fwd.shape == (40,) and bwd is None
    assert g.log[-1]["op"] == "ring" and g.log[-1]["bytes"] == 40


def test_dry_layout_is_split_fleet_meshs():
    """Rank (0, 0) of pod 0's groups: the real layout's sizes, ranks and
    tiers (world rank p * D * M + d * M + m), one shared log."""
    ctx, pods, log = dry_layout(2, 4, 8)
    assert (ctx.D, ctx.M, ctx.d, ctx.m) == (4, 8, 0, 0)
    assert ctx.data.ranks == [0, 8, 16, 24]
    assert ctx.model.ranks == list(range(8))
    assert ctx.world.tier == "fleet" and ctx.world.size == 32
    assert pods.ranks == [0, 32] and pods.tier == "pod"
    assert ctx.data.log is log and pods.log is log
    _, pods, _ = dry_layout(4, 1, 2, n_edge=2)
    assert (pods.intra.ranks, pods.cross.ranks) == ([0, 2], [0, 4])
    assert dry_layout(1, 2, 2)[1] is None


# ---- the CLI, the sweep, and no JAX ---------------------------------------


def test_cli_writes_records_and_prints_two_lines(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "seamless-m4t-medium", "--shape", "decode_32k", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("[16x16] seamless-m4t-medium x decode_32k "
                               "(acesync): OK")
    assert lines[1].lstrip().startswith("flops/dev=")
    rec = json.loads((tmp_path / "16x16_seamless-m4t-medium_decode_32k_"
                      "acesync.json").read_text())
    assert rec["ok"] and rec["mode"] == "decode"
    assert rec["walker"]["flops_per_device"] > 0
    assert rec["bytes_per_device"] >= rec["memory"]["state_bytes"]
    assert "reduce/model" in rec["walker"]["collective_bytes_per_device"]


def test_sweep_todo_and_resume(tmp_path, monkeypatch, capsys):
    """The reference's todo list (64 cells, then the strategy
    comparison), and an ``ok`` record skips its cell."""
    from repro_torch.strategies import list_strategies
    todo = sweep.todo_list()
    assert len(todo) == 2 * len(cells()) + len(list_strategies()) - 1 + 5
    assert todo[0] == (cells()[0][0], cells()[0][1], True, "acesync")
    assert todo[-1] == ("paper-350m", "train_4k", False, "acesync")
    path = sweep.record_path(str(tmp_path), "16x16", "qwen3-8b", "train_4k",
                             "acesync")
    with open(path, "w") as f:
        json.dump({"ok": True}, f)

    def never(*a, **k):
        raise AssertionError("a done cell was run")
    monkeypatch.setattr(subprocess, "run", never)
    assert sweep.run("qwen3-8b", "train_4k", False, "acesync",
                     str(tmp_path), 10)
    assert "skip 16x16 qwen3-8b train_4k acesync (done)" in \
        capsys.readouterr().out


def test_importing_the_dry_run_loads_no_jax():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.sweep\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print('BAD', bad) if bad else print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "CLEAN"
