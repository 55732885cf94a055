"""The port's checkpointer (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same on-disk format, both ways.

* The reference's own cases (``TestCheckpointer`` and
  ``TestCheckpointIntegrity`` of tests/test_substrates.py), as cases of the
  port's checkpointer on trees of tensors: roundtrip, LATEST and prune,
  the pod dimension cut, CRC bit-flip fallback, a truncated leaf, an
  explicit step that raises, a crash mid-save, a lost LATEST, prune keeps
  LATEST's target, a loud background failure, retries, a structure
  mismatch, and a shape mismatch (a stale directory of another model).
  Where the reference writes the same tree, the leaf files are the same
  bytes and the manifests carry the same CRCs.
* Leaf order: ``reference_leaf_paths`` of a port train state is the
  reference's ``tree_flatten_with_path`` order of its state.
* Two-way format and the multi-pod save, with P = 3 gloo pod processes on
  the smoke model: each pod saves its own state, and the files equal the
  reference's ``Checkpointer`` saving the stacked state, byte for byte,
  CRCs included; the reference's ``restore`` reads the port's checkpoint
  back to the same arrays; a P = 2 fleet restores it cut to rows 0 and 1,
  and a P = 2 checkpoint restores on P = 3 tiled (row p mod 2); a
  checkpoint the reference wrote of a P = 2 state restores on every pod
  to exactly ``convert.pod_state_from_reference``'s state for its row.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import (CheckpointCorruptError,
                                                 Checkpointer)
from repro_torch.runtime.faults import (corrupt_checkpoint_leaf,
                                        truncate_checkpoint_leaf)

SEQ = 32


def _two(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = {"a": torch.arange(512, dtype=torch.float32),
             "b": torch.ones((64, 8))}
    ck.save(5, state, extras={"tag": 5}, blocking=True)
    ck.save(10, state, extras={"tag": 10}, blocking=True)
    return ck, state


def _template(state):
    return T.tree_map(lambda x: torch.full_like(x, -7), state)


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
            if n.startswith("leaf_")}


def case_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path / "port"))
    state = {"a": torch.arange(10, dtype=torch.float32),
             "b": {"c": torch.ones((3, 4)),
                   "n": torch.tensor(3, dtype=torch.int32)}}
    ck.save(5, state, extras={"pipe": {"seed": 1, "step": 7}},
            blocking=True)
    assert ck.latest_step() == 5
    got, extras = ck.restore(_template(state))
    for x, y in zip(T.leaves(got), T.leaves(state)):
        assert torch.equal(x, y)
    assert extras["pipe"]["step"] == 7
    # the reference writes the same files for the same tree (pod dim 1)
    jck = JCheckpointer(str(tmp_path / "ref"))
    jck.save(5, jax.tree.map(lambda x: jnp.asarray(x.numpy()[None]), state),
             extras={"pipe": {"seed": 1, "step": 7}}, blocking=True)
    p, r = tmp_path / "port/step_00000005", tmp_path / "ref/step_00000005"
    assert _files(p) == _files(r)
    mp, mr = (json.loads((d / "manifest.json").read_text()) for d in (p, r))
    assert mp["leaves"] == mr["leaves"] and mp["extras"] == mr["extras"]
    assert mp["treedef_repr"] is None and mp["leaf_paths"] == ["a", "b/c",
                                                               "b/n"]
    assert (tmp_path / "port/LATEST").read_text() == \
        (tmp_path / "ref/LATEST").read_text()


def case_latest_pointer_and_prune(tmp_path):
    ck = Checkpointer(str(tmp_path))
    for s in (1, 2, 3, 4):
        ck.save(s, {"a": torch.zeros(4)}, blocking=True)
    assert ck.latest_step() == 4
    ck.prune(keep=2)
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("step_")) == ["step_00000003",
                                                "step_00000004"]


def case_pod_dim_cut(tmp_path):
    """A 2-pod checkpoint (the reference's) restores on one pod: row 0."""
    JCheckpointer(str(tmp_path)).save(
        1, {"p": jnp.stack([jnp.ones(4), jnp.ones(4) * 2])}, blocking=True)
    got, _ = Checkpointer(str(tmp_path)).restore({"p": torch.zeros(4)})
    assert torch.equal(got["p"], torch.ones(4))


def case_crc_detects_bitflips_and_falls_back(tmp_path):
    ck, state = _two(tmp_path)
    path = corrupt_checkpoint_leaf(str(tmp_path), leaf=0, step=10)
    assert path and path.endswith("leaf_0.npy")
    assert ck.verify(10, deep=False)
    assert not ck.verify(10, deep=True)
    got, extras = ck.restore(_template(state))
    assert extras["tag"] == 5
    assert 10 in ck.corrupt_steps
    assert torch.equal(got["a"], torch.arange(512, dtype=torch.float32))


def case_truncated_leaf_falls_back(tmp_path):
    ck, state = _two(tmp_path)
    assert truncate_checkpoint_leaf(str(tmp_path), leaf=1, step=10)
    _, extras = ck.restore(_template(state))
    assert extras["tag"] == 5


def case_explicit_step_raises_on_corruption(tmp_path):
    ck, state = _two(tmp_path)
    corrupt_checkpoint_leaf(str(tmp_path), leaf=0, step=10)
    with pytest.raises(CheckpointCorruptError):
        ck.restore(_template(state), step=10)


def case_crash_mid_save_tmp_ignored_and_cleaned(tmp_path):
    ck, state = _two(tmp_path)
    junk = tmp_path / "step_00000015.tmp"
    junk.mkdir()
    (junk / "leaf_0.npy").write_bytes(b"partial")
    assert ck.latest_step() == 10
    _, extras = ck.restore(_template(state))
    assert extras["tag"] == 10
    ck.prune(keep=2)
    assert not junk.exists()


def case_latest_pointer_lost_falls_back_to_scan(tmp_path):
    ck, _ = _two(tmp_path)
    os.remove(tmp_path / "LATEST")
    assert ck.latest_step() == 10
    (tmp_path / "LATEST").write_text("step_garbage")
    assert ck.latest_step() == 10


def case_prune_never_removes_latest_target(tmp_path):
    ck = Checkpointer(str(tmp_path))
    for s in (1, 2, 3, 4):
        ck.save(s, {"a": torch.zeros(4)}, blocking=True)
    (tmp_path / "LATEST").write_text("step_00000002")
    ck.prune(keep=1)
    left = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert "step_00000002" in left and "step_00000004" in left


def case_background_write_failure_is_loud(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    ck.dir = str(blocker / "ck")
    ck.BACKOFF_S = 0.001
    ck.save(1, {"a": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="failed in the background"):
        ck.wait()
    ck.wait()                   # surfaced once, then cleared


def case_write_retries_transient_failure(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.BACKOFF_S = 0.001
    real_write, calls = ck._write, []

    def flaky(step, leaves, payload):
        calls.append(step)
        if len(calls) < 3:
            raise OSError("transient NFS blip")
        return real_write(step, leaves, payload)

    ck._write = flaky
    ck.save(7, {"a": torch.arange(4.0)}, blocking=True)
    assert len(calls) == 3
    assert ck.latest_step() == 7


def case_structure_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(4), "b": torch.ones(4)}, blocking=True)
    with pytest.raises(ValueError, match="different tree structure"):
        ck.restore({"x": torch.zeros(4), "y": torch.zeros(4)})


def case_shape_mismatch_raises(tmp_path):
    """A directory left by a run of another shape raises, never loads."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(4)}, blocking=True)
    tmpl = {"a": torch.full((5,), 3.0)}
    with pytest.raises(ValueError, match="checkpoint holds"):
        ck.restore(tmpl)
    assert torch.equal(tmpl["a"], torch.full((5,), 3.0))


CASES = {n[len("case_"):]: f for n, f in globals().items()
         if n.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_checkpointer_cases(tmp_path, case):
    CASES[case](tmp_path)


# ---------------------------------------------------------------------------
# the train state's leaf order
# ---------------------------------------------------------------------------


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def _runs():
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.configs.base import RunConfig as JRun, ShapeConfig as JShape
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    kw = dict(warmup_steps=1, total_steps=50)
    return (JRun(model=J_SMOKE["paper-350m"],
                 shape=JShape("t", SEQ, 2, "train"), **kw),
            RunConfig(model=SMOKE_ARCHS["paper-350m"],
                      shape=ShapeConfig("t", SEQ, 2, "train"), **kw))


def _ref_state(strategy, n_pods=1):
    """The reference's initial train state, P rows (row p = row 0 + p)."""
    from repro.core.trainer import Trainer as JTrainer
    from repro.models.registry import build_model as jbuild
    jrun, _ = _runs()
    jt = JTrainer(jbuild(jrun.model, jrun), jrun, mesh=None,
                  strategy=strategy)
    st = jt.init_state(jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: jnp.concatenate(
        [x + p for p in range(n_pods)]), st)


def _port_trainer(strategy, pods=None):
    from repro_torch.core.trainer import Trainer
    from repro_torch.models.registry import build_model
    _, run = _runs()
    return Trainer(build_model(run.model, run, device="cpu"), run,
                   strategy=strategy, pods=pods)


@pytest.mark.parametrize("strategy", ["acesync", "fullsync"])
def test_reference_leaf_order(strategy):
    """``leaf_<k>.npy`` names the same leaf in both packages."""
    ref = [_key(p) for p, _ in
           jax.tree_util.tree_flatten_with_path(_ref_state(strategy))[0]]
    tr = _port_trainer(strategy)
    state = tr.init_state(0)
    assert T.reference_leaf_paths(state) == ref
    assert ("anchor/embed" in ref) == (strategy == "acesync")
    # the inverse rebuilds the state's structure
    flat = [x for _, x in T.reference_leaves_with_path(state)]
    back = T.reference_unflatten(state, flat)
    assert T.reference_leaf_paths(back) == ref
    assert all(a is b for a, b in zip(
        flat, [x for _, x in T.reference_leaves_with_path(back)]))


# ---------------------------------------------------------------------------
# P = 3 pod processes: multi-pod save, cut, tile, the reference's files
# ---------------------------------------------------------------------------


def _host_leaves(state):
    return [x.detach().numpy().copy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for _, x in T.reference_leaves_with_path(state)]


def _pod_checkpoints(group, tmp, ref_flat_path):
    from repro_torch import convert
    from repro_torch.core.trainer import Trainer
    tmp = str(tmp)
    tr = _port_trainer("acesync", pods=group)
    out = {}
    # each pod saves its own state (pods differ: seed = rank)
    state = tr.init_state(group.rank + 1)
    ck = Checkpointer(os.path.join(tmp, "p3"), pods=group)
    ck.save(7, state, extras={"tag": 7}, blocking=True)
    out["saved"] = _host_leaves(state)
    out["copy_s"] = ck.last_save["copy_s"]
    got, extras = ck.restore(tr.init_state(99))
    out["restored"], out["extras"] = _host_leaves(got), extras
    # cut: a P = 2 fleet of pods 0 and 1 restores rows 0 and 1 ...
    sub = group.regroup([0, 1])
    if sub is not None:
        tr2 = Trainer(tr.model, tr.run, strategy="acesync", pods=sub)
        got, _ = Checkpointer(os.path.join(tmp, "p3"),
                              pods=sub).restore(tr2.init_state(99))
        out["cut"] = _host_leaves(got)
        # ... and saves a P = 2 checkpoint of its own state
        Checkpointer(os.path.join(tmp, "p2"), pods=sub).save(
            5, tr2.init_state(10 + sub.rank), blocking=True)
    group.barrier()
    # tile: three pods restore the P = 2 checkpoint, row p mod 2
    got, _ = Checkpointer(os.path.join(tmp, "p2"),
                          pods=group).restore(tr.init_state(99))
    out["tile"] = _host_leaves(got)
    # the reference's checkpoint of a P = 2 state, row p mod 2
    got, extras = Checkpointer(os.path.join(tmp, "ref2"),
                               pods=group).restore(tr.init_state(99))
    out["from_ref"] = _host_leaves(got)
    out["from_ref_extras"] = extras
    flat = dict(np.load(ref_flat_path))
    out["want_ref"] = _host_leaves(convert.pod_state_from_reference(
        flat, tr, group.rank % 2))
    return out


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_pods
    tmp = tmp_path_factory.mktemp("ckpt_pods")
    ref2 = _ref_state("acesync", n_pods=2)
    JCheckpointer(str(tmp / "ref2")).save(3, ref2, extras={"tag": 3},
                                          blocking=True)
    np.savez(tmp / "ref2.npz", **{
        _key(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(ref2)[0]})
    out = spawn_pods(_pod_checkpoints, 3, "cpu",
                     args=(str(tmp), str(tmp / "ref2.npz")), threads=1,
                     init_method=f"file://{tmp / 'store'}", timeout=300)
    return tmp, out


def test_multi_pod_save_writes_the_stacked_files(pods):
    """Three pods writing their rows = the reference's Checkpointer saving
    the stacked state: the same leaf files byte for byte, the same CRCs;
    and every pod restores its own row."""
    tmp, out = pods
    stacked = [np.stack(rows) for rows in zip(*(o["saved"] for o in out))]
    treedef = jax.tree_util.tree_structure(_ref_state("acesync"))
    JCheckpointer(str(tmp / "ref3")).save(
        7, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(x) for x in stacked]),
        extras={"tag": 7}, blocking=True)
    p, r = tmp / "p3/step_00000007", tmp / "ref3/step_00000007"
    assert _files(p) == _files(r)
    mp, mr = (json.loads((d / "manifest.json").read_text()) for d in (p, r))
    assert [m["crc32"] for m in mp["leaves"]] == \
        [m["crc32"] for m in mr["leaves"]]
    assert mp["leaves"] == mr["leaves"] and mp["n_leaves"] == len(stacked)
    for o in out:
        assert o["extras"] == {"tag": 7}
        for a, b in zip(o["restored"], o["saved"]):
            np.testing.assert_array_equal(a, b)


def test_reference_restores_a_port_checkpoint(pods):
    """The reference's ``restore`` (treedef_repr null: not checked) reads
    the port's P = 3 checkpoint to the pods' arrays."""
    tmp, out = pods
    specs = jax.tree.map(lambda x: jax.ShapeDtypeStruct((3,) + x.shape[1:],
                                                        x.dtype),
                         _ref_state("acesync"))
    state, extras = JCheckpointer(str(tmp / "p3")).restore(specs)
    assert extras == {"tag": 7}
    for i, leaf in enumerate(jax.tree.leaves(state)):
        for p, o in enumerate(out):
            np.testing.assert_array_equal(np.asarray(leaf)[p],
                                          o["saved"][i])


def test_pod_dimension_cut_and_tile(pods):
    """P = 3 -> 2 reads rows 0 and 1; P = 2 -> 3 reads row p mod 2."""
    _, out = pods
    for p in (0, 1):
        for a, b in zip(out[p]["cut"], out[p]["saved"]):
            np.testing.assert_array_equal(a, b)
    assert "cut" not in out[2]
    for p in (0, 1, 2):
        for a, b in zip(out[p]["tile"], out[p % 2]["tile"]):
            np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in
                   zip(out[0]["tile"], out[1]["tile"]))


def test_reference_checkpoint_restores_to_converted_state(pods):
    """The reference's checkpoint of a P = 2 state restores on each pod to
    ``convert.pod_state_from_reference``'s state, bit for bit."""
    _, out = pods
    for o in out:
        assert o["from_ref_extras"] == {"tag": 3}
        assert len(o["from_ref"]) == len(o["want_ref"])
        for a, b in zip(o["from_ref"], o["want_ref"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the MoE family's, the recurrent families' and the frontend archs' train
# states, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_checkpoints_restore_across_packages(arch, tmp_path):
    """A MoE train state (the expert stacks and router, their AdamW
    moments, EF residuals and anchor) in the reference's on-disk format,
    both ways (:func:`_restores_across_packages`)."""
    flat = _restores_across_packages(arch, tmp_path)
    assert any(k.endswith("ffn/router") for k in flat)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_recurrent_checkpoints_restore_across_packages(arch, tmp_path):
    """A recurrent train state (mamba's ``blocks/slot0`` stacks; the
    hybrid's (rec, rec, attn) slots and its unrolled ``tail/slot{i}``
    leaves of shape (1, ...)) in the reference's on-disk format, both
    ways (:func:`_restores_across_packages`)."""
    flat = _restores_across_packages(arch, tmp_path)
    want = ("params/blocks/slot0/A_log" if arch == "falcon-mamba-7b"
            else "params/tail/slot1/mix/lam")
    assert want in flat


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_frontend_checkpoints_restore_across_packages(arch, tmp_path):
    """The encoder-decoder's train state (``dec_blocks`` with their
    cross-attention, ``enc_blocks``, ``enc_norm``) and the VLM's, stepped
    on the pipeline's frames / patch embeddings, in the reference's
    on-disk format, both ways (:func:`_restores_across_packages`)."""
    flat = _restores_across_packages(arch, tmp_path)
    want = ("params/dec_blocks/cross_attn/wk"
            if arch == "seamless-m4t-medium" else "params/blocks/slot0/attn/wq")
    assert want in flat


def _restores_across_packages(arch, tmp_path):
    """The reference's checkpoint of its initial state restores in the
    port to exactly ``convert.state_from_reference``'s state, and the
    port's checkpoint of its state one step on restores in the reference
    to the port's arrays; the leaf order is the reference's.  Returns
    the reference state's leaf paths."""
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.configs.base import RunConfig as JRun, ShapeConfig as JShape
    from repro.core.trainer import Trainer as JTrainer
    from repro.models.registry import build_model as jbuild
    from repro_torch import convert
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model
    kw = dict(warmup_steps=1, total_steps=50)
    jrun = JRun(model=J_SMOKE[arch], shape=JShape("t", SEQ, 2, "train"), **kw)
    run = RunConfig(model=SMOKE_ARCHS[arch],
                    shape=ShapeConfig("t", SEQ, 2, "train"), **kw)
    jst = JTrainer(jbuild(jrun.model, jrun), jrun, mesh=None,
                   strategy="acesync").init_state(jax.random.PRNGKey(0))
    JCheckpointer(str(tmp_path / "ref")).save(3, jst, extras={"tag": 3},
                                              blocking=True)
    tr = Trainer(build_model(run.model, run, device="cpu"), run)
    flat = {_key(p): np.asarray(x)[0]
            for p, x in jax.tree_util.tree_flatten_with_path(jst)[0]}
    state = convert.state_from_reference(flat, tr)
    assert T.reference_leaf_paths(state) == list(flat)
    want = _host_leaves(state)
    got, extras = Checkpointer(str(tmp_path / "ref")).restore(
        tr.init_state(99))
    assert extras == {"tag": 3}
    for a, b in zip(_host_leaves(got), want):
        np.testing.assert_array_equal(a, b)
    # the port's checkpoint of the state one step on, read by the reference
    state = convert.state_from_reference(flat, tr)
    batch = next(TokenPipeline(tr.model, run.shape, seed=0))
    plan = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.sizes))], (1.0,))
    state, _ = tr.step(state, batch, plan, "grad_sync")
    saved = _host_leaves(state)
    Checkpointer(str(tmp_path / "port")).save(5, state, extras={"tag": 5},
                                              blocking=True)
    specs = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         jst)
    back, extras = JCheckpointer(str(tmp_path / "port")).restore(specs)
    assert extras == {"tag": 5}
    leaves = jax.tree.leaves(back)
    assert len(leaves) == len(saved)
    moved = 0
    for leaf, a, b in zip(leaves, saved, want):
        np.testing.assert_array_equal(np.asarray(leaf)[0], a)
        moved += not np.array_equal(a, b)
    assert moved
    return flat
