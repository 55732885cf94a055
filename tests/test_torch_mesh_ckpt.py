"""Checkpoints on a within-pod ("data", "model") mesh, on the CPU: the
state's layout on a rank, the ranks' shards assembled back into the
reference's whole leaves, and the loop's rank-0 duties.  Against the live
reference: tests/test_torch_mesh_ckpt_<D>x<M>.py.

* ``Trainer.state_layout`` on every rank of (1, 2), (2, 1), (2, 2) and
  (1, 4) meshes (contexts for shapes only): each rank's index selects a
  region of its leaf's global shape the size of its own leaf; the
  regions the writing ranks write cover every entry of every global leaf
  exactly once (a replicated shard is written by the first rank holding
  it, a whole leaf by rank 0), and every rank's region is some writer's.
* ``convert.reference_from_shards`` assembles the ranks'
  ``state_from_reference`` shards back into the reference's leaves bit
  for bit, and refuses ranks that disagree on a replicated shard or
  leave an entry unheld, naming the leaf.
* On a (1, 2) gloo mesh with a checkpoint corruption scheduled, only rank
  0 corrupts a leaf and only rank 0 prints.
* The shard writer: its ``pwrite`` of each contiguous run places a region
  (whole, a row, a shard along an outer or an inner dimension, empty) as
  a numpy slice assignment does; a write the operating system refuses
  (a file size limit, in a process of its own) fails the save with
  ``OSError`` and leaves the previous checkpoint intact; pods x a mesh
  places row p's shards, a two-tier fleet of meshes is refused.
* ``launch.mesh.sub_mesh``: meshes of some processes of a fleet of four
  gloo processes, each mesh's collectives on its own ranks.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import os
import subprocess
import sys
from pathlib import Path

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import (Checkpointer, LeafShard,
                                                 MeshLayout)
from repro_torch.core.trainer import Trainer, param_path
from repro_torch.models import shardctx as SC
from repro_torch.models.registry import build_model
from torch_mesh_train_ranks import run_config

#: (arch, mesh): the SMOKE archs with two K/V heads do not train on four
#: "model" ranks; paper-350m has four
LAYOUTS = (("qwen3-8b", (1, 2)), ("qwen3-moe-30b-a3b", (2, 1)),
           ("dbrx-132b", (2, 2)), ("qwen3-moe-30b-a3b", (2, 2)),
           ("paper-350m", (1, 4)))


def _rank_states(arch, mesh):
    """Per rank of ``mesh``: (trainer, its state from a seeded whole
    flat state, that flat state)."""
    run = run_config(arch)
    D, M = mesh
    state = Trainer(build_model(run.model, run, device="cpu"),
                    run).init_state(0)
    flat = {T.path_str(p): x.detach().numpy().copy()
            for p, x in T.reference_leaves_with_path(state)}
    rng = np.random.RandomState(0)
    flat = {k: (np.asarray(rng.randn(*a.shape), np.float32)
                if a.dtype == np.float32 else a) for k, a in flat.items()}
    out = []
    for r in range(D * M):
        tr = Trainer(build_model(run.model, run, device="cpu",
                                 ctx=SC.ShardCtx(D, M, r // M, r % M)), run)
        out.append((tr, convert.state_from_reference(flat, tr)))
    return out, flat


@pytest.mark.parametrize("arch,mesh", LAYOUTS)
def test_state_layout_writes_every_entry_once(arch, mesh):
    ranks, flat = _rank_states(arch, mesh)
    paths = T.reference_leaf_paths(ranks[0][1])
    layouts = [tr.state_layout(st) for tr, st in ranks]
    for i, key in enumerate(paths):
        shape = flat[key].shape
        written = np.zeros(shape, np.int32)
        regions = set()
        for r, ((_, st), lay) in enumerate(zip(ranks, layouts)):
            sh = lay[i]
            assert sh.shape == shape, key
            leaf = T.reference_leaves_with_path(st)[i][1]
            assert np.zeros(shape)[sh.index].shape == tuple(leaf.shape), key
            if param_path(key) is None:
                assert sh.writes == (r == 0), (key, r)
            if sh.writes:
                written[sh.index] += 1
                regions.add(str(sh.index))
        assert (written == 1).all(), (key, written.min(), written.max())
        assert all(str(lay[i].index) in regions for lay in layouts), key


@pytest.mark.parametrize("arch,mesh", LAYOUTS[2:4])
def test_reference_from_shards_assembles_and_refuses(arch, mesh):
    ranks, flat = _rank_states(arch, mesh)
    shards = [convert.rank_shards(st, tr) for tr, st in ranks]
    whole = convert.reference_from_shards(shards)
    assert set(whole) == set(flat)
    for key, x in flat.items():
        np.testing.assert_array_equal(whole[key], x, err_msg=key)
    # a replicated leaf (every rank holds the final norm) that differs
    key = "params/final_norm"
    bad = [dict(s) for s in shards]
    part, index, shape = bad[-1][key]
    bad[-1][key] = (part + 1, index, shape)
    with pytest.raises(ValueError, match=f"{key}: ranks hold different"):
        convert.reference_from_shards(bad)
    # a rank missing: its shards of the sharded leaves are unheld
    with pytest.raises(ValueError, match="no rank holds"):
        convert.reference_from_shards(shards[:1])


def test_only_mesh_rank_0_corrupts_and_logs(tmp_path):
    from repro_torch.launch.mesh import spawn_mesh
    from torch_mesh_ckpt_ranks import fault_rank
    got = spawn_mesh(fault_rank, 1, 2, "cpu", args=(str(tmp_path),),
                     init_method=f"file://{tmp_path / 'store'}", threads=1,
                     timeout=300)
    assert [g["calls"] for g in got] == [1, 0]
    assert "FAULT step 3: corrupted" in got[0]["printed"]
    assert "step     0 loss=" in got[0]["printed"]
    assert got[1]["printed"] == ""


#: (file shape with its pod rows, region): whole, a row, outer and inner
#: shards, a shard of two inner dimensions, an empty one, a scalar's row
REGIONS = (((1, 4, 6), np.s_[0:1, :, :]),
           ((3, 4, 6), np.s_[1:2, :, :]),
           ((1, 6, 4, 8), np.s_[0:1, 2:5, :, :]),
           ((1, 6, 4, 8), np.s_[0:1, :, :, 4:8]),
           ((2, 3, 5, 4, 6), np.s_[1:2, :, 1:4, 2:3, 0:2]),
           ((1, 4, 6), np.s_[0:1, 2:2, :]),
           ((2,), (np.s_[1:2],)))


@pytest.mark.parametrize("shape,region", REGIONS)
def test_shard_writes_place_a_region_as_a_slice(tmp_path, shape, region):
    rng = np.random.RandomState(1)
    path = str(tmp_path / "leaf_0.npy")
    np.save(path, rng.randn(*shape).astype(np.float32))
    want = np.load(path)
    part = rng.randn(*want[region].shape).astype(np.float32)
    want[region] = part
    Checkpointer(str(tmp_path / "ck"))._write_shards(
        str(tmp_path), [(0, region, part)])
    np.testing.assert_array_equal(np.load(path), want)


REFUSED_WRITE = r"""
import errno, resource, signal, sys
import torch
from repro_torch.checkpoint.checkpointer import Checkpointer
signal.signal(signal.SIGXFSZ, signal.SIG_IGN)
ck = Checkpointer(sys.argv[1])
ck.BACKOFF_S = 0.001
state = {"a": torch.arange(4096, dtype=torch.float32),
         "b": torch.ones(3, 5)}
ck.save(1, state, blocking=True)
soft, hard = resource.getrlimit(resource.RLIMIT_FSIZE)
write = ck._write_shards


def limited(*args):
    # every file this process writes now ends at 64 bytes: the leaves'
    # data lies past their headers
    resource.setrlimit(resource.RLIMIT_FSIZE, (64, hard))
    try:
        write(*args)
    finally:
        resource.setrlimit(resource.RLIMIT_FSIZE, (soft, hard))


ck._write_shards = limited
ck.save(2, state)
try:
    ck.wait()
    print("NO ERROR")
except RuntimeError as e:
    cause = e.__cause__
    print(type(cause).__name__, cause.errno == errno.EFBIG)
print(ck.latest_step(), ck.verify(1, deep=True))
"""


def test_a_refused_shard_write_raises(tmp_path):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", REFUSED_WRITE,
                          str(tmp_path / "ck")], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["OSError", "True", "1", "True"], out
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "ck")
                   if n != "step_00000002.tmp")


def test_checkpoints_of_pods_times_a_mesh_are_refused(tmp_path):
    """Pods x mesh checkpoints (ROADMAP Queue 1 item 3): rank (p, d, m)
    places its shard in row p of each leaf; on a two-tier fleet of meshes
    (item 3b) the loop builds, hierarchical and not elastic, and its
    checkpointer holds one row per fleet slot c * E + e."""
    from repro_torch.launch.train import TrainLoop
    pods = type("Pods", (), {"size": 2, "rank": 1})()
    shard = LeafShard((4, 6), (slice(0, 4), slice(3, 6)), False)
    ck = Checkpointer(str(tmp_path), pods=pods,
                      mesh=MeshLayout(None, lambda state: [shard]))
    assert ck._rows() == 2
    assert ck._regions({"w": torch.zeros(4, 3)}, 2) == [LeafShard(
        (4, 6), (slice(1, 2), slice(0, 4), slice(3, 6)), False)]
    run = run_config("qwen3-8b")
    model = build_model(run.model, run, device="cpu", ctx=SC.ShardCtx(1, 1))
    two_tier = type("Pods", (), {"size": 4, "n_edge": 2, "rank": 3,
                                 "ranks": [1, 3, 5, 7]})()
    loop = TrainLoop(model, dataclasses.replace(run, ckpt_dir=str(tmp_path)),
                     pods=two_tier)
    assert loop.trainer.scheduler.hier_enabled and not loop.elastic
    assert loop.clusters.k == loop.trainer.scheduler.n_cross == 2
    assert loop.ckpt._rows() == 4
    assert loop.ckpt._regions({"w": torch.zeros(4, 3)}, 4)[0].index[0] == \
        slice(3, 4)


def test_sub_mesh_of_a_fleet(tmp_path):
    """``launch.mesh.sub_mesh``: meshes of some of a fleet's processes,
    the groups made by every process; collectives stay on each mesh."""
    from repro_torch.launch.mesh import spawn_pods
    from torch_mesh_ckpt_ranks import sub_mesh_rank
    got = spawn_pods(sub_mesh_rank, 4, "cpu",
                     init_method=f"file://{tmp_path / 'store'}", threads=1,
                     timeout=300)
    assert got[0] == {"b": (0, 0, 0, 3.0, 1.0, [0, 1], [0], [0, 1])}
    assert got[1] == {"b": (1, 1, 0, 3.0, 2.0, [0, 1], [1], [0, 1])}
    assert got[2] == {"a": (0, 0, 0, 3.0, 7.0, [2], [2, 3], [2, 3])}
    assert got[3] == {"a": (1, 0, 1, 4.0, 7.0, [3], [2, 3], [2, 3])}
