"""Training on a within-pod ("data", "model") mesh, on the CPU: each
collective's adjoint, the models' gradients, the MoE's per-block capacity
under training, the state carried across from the reference onto a
rank, the refusals and the train CLI.  The Trainer against the live
reference: tests/test_torch_mesh_train_ref_<D>x<M>.py.

* Each collective's ``autograd.Function`` on gloo ranks (``spawn_mesh``,
  ``file://`` rendezvous; the rank code is
  ``tests/torch_mesh_train_ranks.py``) on (1, 2), (2, 1) and (2, 2), in
  f64, against one process's autograd of the unsharded computation: the
  tensor-parallel copy-in / reduce-out pair, the FSDP gather (its
  reduce-scatter), the MoE's sequence blocks, the ``all_to_all``, the
  vocab-parallel loss (its logits f32, as the model's: ``F32_RTOL``)
  and lookup.  A rank's gradient of a replicated
  weight is its part, and the ranks' parts must sum to the whole: a
  wrong adjoint shows as a factor M or D.  Within ``F64_RTOL`` = 1e-12
  of the largest entry.  ``PodGroup.reduce_scatter`` equals the
  all-reduce's row bit for bit (gloo, 2 and 4 ranks, rank order).
* SMOKE qwen3-8b, gemma2-9b (a batch of 3: D = 2 does not divide it, and
  every data rank holds the whole batch), qwen3-moe-30b-a3b (31
  positions: M = 2 does not divide them, and every model rank dispatches
  the whole sequence) and dbrx-132b, f32, the MoE at capacity factor
  E / K (nothing drops): the loss and each rank's reduced gradient shard
  (through the remat layers and the chunked loss) against the unsharded
  model within ``F32_RTOL`` = 1e-5 of each leaf's largest entry.
* The MoE at its capacity factor 1.25 with tokens skewed so that blocks
  drop pairs: output and gradients against ``moe_apply_blocked``'s
  autograd on one process within ``F32_RTOL``.
* The refusal of a two-tier fleet of meshes (pods x mesh trains), and
  the train CLI on a (1, 2) mesh, which
  checkpoints and, run again over the same directory, resumes.
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
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.trainer import Trainer
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from repro_torch.models import shardctx as SC
from repro_torch.models.registry import build_model
from torch_mesh_train_ranks import (CB, CF, MOE_ARCH, collective_inputs,
                                    collective_rank, model_case, moe_inputs,
                                    run_config)

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 1), (2, 2))
F64_RTOL = 1e-12
F32_RTOL = 1e-5
#: (arch, seq, batch, capacity factor): the model cases
MODEL_CASES = (("qwen3-8b", 32, 4, None), ("gemma2-9b", 32, 3, None),
               ("qwen3-moe-30b-a3b", 31, 4, 4.0), ("dbrx-132b", 32, 4, 2.0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_mesh
    tmp = tmp_path_factory.mktemp("mesh_grads")
    return {mesh: spawn_mesh(collective_rank, *mesh, "cpu",
                             args=(MODEL_CASES,),
                             init_method=f"file://{tmp / f'{mesh[0]}x{mesh[1]}'}",
                             threads=1, timeout=600)
            for mesh in MESHES}


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, (what, err, tol)


def _leaf(a):
    return torch.from_numpy(np.asarray(a)).clone().requires_grad_(True)


def _rows(mesh, d):
    return SC.ShardCtx(*mesh, d, 0).batch_slice(CB)


def _sum(res, key, i, pick=lambda r: True):
    return sum(r[key][i] for r in res if pick(r))


ids = [f"{d}x{m}" for d, m in MESHES]


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_tensor_parallel_adjoints(ranks, mesh):
    """copy_to_model / reduce_model around a column- and a row-parallel
    product: y and x's gradient whole on every rank, each weight's part
    the data ranks of its column block sum to the whole gradient's."""
    t = {k: _leaf(v) for k, v in collective_inputs().items()
         if k in ("x", "wc", "wr")}
    c = torch.from_numpy(collective_inputs()["c"])
    y = torch.tanh(t["x"] @ t["wc"]) @ t["wr"]
    gx, gc, gr = torch.autograd.grad((y * c).sum(), [t["x"], t["wc"],
                                                     t["wr"]])
    res = ranks[mesh]
    for r in res:
        d, m = r["coords"]
        rows, cols = _rows(mesh, d), slice(*SC.axis_range(CF, mesh[1], m))
        close(r["tp"][0], y.detach()[rows], F64_RTOL, "y")
        close(r["tp"][1], gx[rows], F64_RTOL, "dx")
        same = [q for q in res if q["coords"][1] == m]
        close(sum(q["tp"][2] for q in same), gc[:, cols], F64_RTOL, "dwc")
        close(sum(q["tp"][3] for q in same), gr[cols], F64_RTOL, "dwr")


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_fsdp_gather_adjoint_is_a_reduce_scatter(ranks, mesh):
    a = collective_inputs()
    w = _leaf(a["wc"])
    x, c = torch.from_numpy(a["x"]), torch.from_numpy(a["c"])[..., :1]
    y = torch.tanh(x @ w)
    (gw,) = torch.autograd.grad((y * c).sum(), [w])
    for r in ranks[mesh]:
        d, _ = r["coords"]
        close(r["fsdp"][0], y.detach()[_rows(mesh, d)], F64_RTOL, "y")
        dr = slice(*SC.axis_range(a["wc"].shape[0], mesh[0], d))
        close(r["fsdp"][1], gw[dr], F64_RTOL, "dw shard")


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_sequence_block_adjoints(ranks, mesh):
    """split_model / gather_model: every rank's y and x's gradient whole;
    the replicated weight's gradients of all ranks sum to the whole."""
    a = collective_inputs()
    x, w = _leaf(a["x"]), _leaf(a["wc"][:, :a["x"].shape[-1]])
    y = torch.tanh(x @ w)
    gx, gw = torch.autograd.grad((y * torch.from_numpy(a["c"])).sum(),
                                 [x, w])
    res = ranks[mesh]
    for r in res:
        rows = _rows(mesh, r["coords"][0])
        close(r["blocks"][0], y.detach()[rows], F64_RTOL, "y")
        close(r["blocks"][1], gx[rows], F64_RTOL, "dx")
    close(sum(r["blocks"][2] for r in res), gw, F64_RTOL, "dw")


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_all_to_all_adjoint_is_the_reverse(ranks, mesh):
    """The two all_to_alls of expert parallelism, emulated on one
    process: each rank's output and the gradients of its rows and its
    own weight."""
    a = collective_inputs()
    D, M = mesh
    xs = [_leaf(a["a2a"] * (1 + r)) for r in range(D * M)]
    ws = [_leaf(a["a2a_w"][r % M] * (1 + r)) for r in range(D * M)]
    c = torch.from_numpy(a["a2a_c"])
    ys, loss = [None] * (D * M), 0
    for d in range(D):
        grp = [d * M + m for m in range(M)]
        # rank q receives chunk q of every source's rows, by source
        z = [torch.cat([xs[p].chunk(M, 0)[q] for p in grp], 1)
             for q in range(M)]
        out = [torch.tanh(z[q] * ws[grp[q]]) for q in range(M)]
        for p in range(M):
            ys[grp[p]] = torch.cat([out[q].chunk(M, 1)[p]
                                    for q in range(M)], 0)
            loss = loss + (ys[grp[p]] * c).sum()
    gs = torch.autograd.grad(loss, xs + ws)
    for r in ranks[mesh]:
        k = r["coords"][0] * M + r["coords"][1]
        close(r["a2a"][0], ys[k].detach(), F64_RTOL, "y")
        close(r["a2a"][1], gs[k], F64_RTOL, "dx")
        close(r["a2a"][2], gs[D * M + k], F64_RTOL, "dw")


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_vocab_parallel_loss_and_lookup(ranks, mesh):
    """The chunk's vocab-parallel cross-entropy (softcapped) and the
    masked lookup: the loss and x's gradient whole on every rank, each
    rank's gradient its embedding rows'."""
    a = collective_inputs()
    cfg = type("C", (), dict(final_logit_softcap=30.0,
                             emb_scale_by_dim=False))()
    for r in ranks[mesh]:
        d, m = r["coords"]
        rows = _rows(mesh, d)
        vr = slice(*SC.axis_range(16, mesh[1], m))
        x, emb = _leaf(a["x"][rows]), _leaf(a["emb"])
        nll = L._chunk_nll(x, emb, torch.from_numpy(a["labels"][rows]),
                           cfg)
        gx, ge = torch.autograd.grad(nll, [x, emb])
        # the logits are f32, as the model computes them
        close(r["xent"][0], nll.detach(), F32_RTOL, "nll")
        close(r["xent"][1], gx, F32_RTOL, "dx")
        close(r["xent"][2], ge[vr], F32_RTOL, "demb")
        emb = _leaf(a["emb"])
        e = L.embed_lookup(emb, torch.from_numpy(a["tokens"][rows]), cfg,
                           torch.float64)
        (ge,) = torch.autograd.grad(
            (e * torch.from_numpy(a["c"][rows])).sum(), [emb])
        close(r["embed"][0], e.detach(), F64_RTOL, "lookup")
        close(r["embed"][1], ge[vr], F64_RTOL, "lookup demb")


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_reduce_scatter_is_the_all_reduce_row(ranks, mesh):
    """``PodGroup.reduce_scatter`` (gloo) against ``all_reduce_sum`` and
    the rank's row, bit for bit: both sum in rank order."""
    for r in ranks[mesh]:
        got, want = r["rs"]
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in
                                                   MODEL_CASES])
@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_model_gradients_match_the_unsharded_model(ranks, mesh, case):
    model, batch = model_case(*case)
    leaves = T.leaves(model.param_tree())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves)
    paths = [T.path_str(q) for q, _ in T.leaves_with_path(model.param_tree())]
    want = dict(zip(paths, grads))
    for r in ranks[mesh]:
        got_loss, got = r["models"][case]
        assert abs(got_loss - float(loss)) <= F32_RTOL * abs(float(loss))
        assert set(got) == set(want)
        for p, (g, idx) in got.items():
            close(g, want[p].numpy()[idx], F32_RTOL, p)


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_moe_with_drops_trains_as_the_blocked_oracle(ranks, mesh):
    """Capacity 1.25, tokens skewed to expert 0: the mesh's MoE (expert
    parallelism, FSDP, sequence blocks) against ``moe_apply_blocked``'s
    autograd — each block drops pairs of its own, so the answer is not
    the unsharded one."""
    cfg = SMOKE_ARCHS[MOE_ARCH]
    assert cfg.capacity_factor == 1.25
    a = moe_inputs()
    names = ("router", "w_down", "w_gate", "w_up")
    p = {k: _leaf(a[k]) for k in names}
    x = _leaf(a["x"])
    y = TM.moe_apply_blocked(p, x, cfg, *mesh)
    with torch.no_grad():
        whole = TM.moe_apply({k: v.detach() for k, v in p.items()},
                             x.detach(), cfg)
    assert float((y - whole).abs().max()) > 1e-2
    grads = torch.autograd.grad((y * torch.from_numpy(a["c"])).sum(),
                                [x] + [p[k] for k in names])
    want = dict(zip(("x",) + names, grads))
    res = ranks[mesh]
    for r in res:
        q = r["moe"]
        i = q["index"]
        close(q["y"], y.detach()[i["rows"]], F32_RTOL, "y")
        close(q["x"], want["x"][i["rows"]], F32_RTOL, "dx")
        close(q["w_gate"], want["w_gate"][i["e"], i["d"]], F32_RTOL, "wg")
        close(q["w_up"], want["w_up"][i["e"], i["d"]], F32_RTOL, "wu")
        close(q["w_down"], want["w_down"][i["e"], :, i["d"]], F32_RTOL,
              "wd")
    close(sum(r["moe"]["router"] for r in res), want["router"], F32_RTOL,
          "router")


# ---------------------------------------------------------------------------
# the state on a rank, the refusals, the reckoning and the CLI
# ---------------------------------------------------------------------------


def test_state_from_reference_cuts_every_tree_on_a_rank():
    """``convert.state_from_reference`` on each rank of a (2, 2) mesh:
    params, m, v, the error buffers and the anchor are the reference's
    leaves at ``shard_index``, bit for bit; the rest whole."""
    import jax
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.configs.base import RunConfig as JRun
    from repro.core.trainer import Trainer as JTrainer
    from repro.models.registry import build_model as jbuild
    arch = "qwen3-moe-30b-a3b"
    run = run_config(arch)
    jrun = JRun(model=dataclasses.replace(J_SMOKE[arch], dtype="float32"),
                shape=run.shape)
    jt = JTrainer(jbuild(jrun.model, jrun), jrun, mesh=None)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jt.init_state(jax.random.PRNGKey(0)))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        a = np.asarray(leaf)[0]
        # every tree distinct, so that a tree cut from another shows
        flat[key] = a + np.float32(len(key)) if a.dtype == np.float32 \
            else a
    trees = ("params/", "m/", "v/", "ace/errors/", "anchor/")
    for d in range(2):
        for m in range(2):
            ctx = SC.ShardCtx(2, 2, d, m)
            tr = Trainer(build_model(run.model, run, device="cpu", ctx=ctx),
                         run)
            state = convert.state_from_reference(flat, tr)
            got = dict(zip(T.reference_leaf_paths(state),
                           (x for _, x in T.reference_leaves_with_path(
                               state))))
            assert set(got) == set(flat)
            for k, want in flat.items():
                t = next((t for t in trees if k.startswith(t)), None)
                if t is not None:
                    want = want[tr.model.shard_index(k[len(t):])]
                np.testing.assert_array_equal(
                    np.ascontiguousarray(got[k].detach().numpy()), want,
                    err_msg=k)


def test_a_mesh_whose_shards_are_not_the_references_is_refused():
    """Two experts over four "model" ranks: the port replicates each
    expert over two ranks, the reference splits the experts' stacks — the
    Trainer refuses, naming the leaf.  (K/V heads fewer than "model" are
    held as the reference splits them: tests/test_torch_mesh_recurrent.py
    trains starcoder2-3b's two over four ranks.)"""
    cfg = dataclasses.replace(SMOKE_ARCHS["dbrx-132b"], n_experts=2)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"))
    model = build_model(cfg, run, device="cpu", ctx=SC.ShardCtx(1, 4))
    with pytest.raises(ValueError, match="ffn/w_.*not the reference's"):
        Trainer(model, run)


def test_pods_times_a_mesh_is_refused_and_a_mesh_loop_checkpoints(tmp_path):
    """Pods x mesh trains (ROADMAP Queue 1 item 3: the trainer prices its
    plans for the pods), and a two-tier fleet of meshes too (item 3b: its
    scheduler hierarchical, C = 2 clusters x E = 2 members); a loop on a
    mesh takes ``ckpt_every`` and checkpoints through its trainer's
    layout."""
    from repro_torch.launch.train import TrainLoop
    run = run_config("qwen3-8b")
    model = build_model(run.model, run, device="cpu",
                        ctx=SC.ShardCtx(1, 1))
    pods = type("Pods", (), {"size": 2, "n_edge": 1})()
    tr = Trainer(model, run, pods=pods)
    assert tr.n_pods == 2 and tr.scheduler.n_pods == 2
    two_tier = type("Pods", (), {"size": 4, "n_edge": 2})()
    tr = Trainer(model, run, pods=two_tier)
    assert (tr.n_pods, tr.n_edge, tr.scheduler.n_cross) == (4, 2, 2)
    assert tr.scheduler.hier_enabled
    run = dataclasses.replace(run, ckpt_every=5, ckpt_dir=str(tmp_path))
    loop = TrainLoop(model, run)
    assert loop.ckpt.mesh.layout == loop.trainer.state_layout


def test_mesh_train_reckoning():
    """Per-card parameters: a (1, 1) mesh holds the whole model, the
    ranks of a (2, 2) mesh each their shards (the embedding split over
    "model" only); the depth rule gives the most layers under the
    limit."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import memory
    from repro_torch.models import flops
    cfg = dataclasses.replace(ARCHS["qwen3-8b"], n_layers=2)
    model = build_model(cfg, device="meta")
    (whole,) = memory.mesh_param_counts(cfg, 1, 1)
    assert whole == sum(p.numel() for p in model.parameters())
    per = memory.mesh_param_counts(cfg, 2, 2)
    assert len(set(per)) == 1
    # the embedding is held twice (once per data rank), the norms by all
    # four ranks, every other weight once
    emb = cfg.padded_vocab * cfg.d_model
    norms = sum(p.numel() for q, p in T.leaves_with_path(model.param_tree())
                if "norm" in q[-1] or q[-1].startswith("ln"))
    assert sum(per) == whole + emb + 3 * norms
    full = ARCHS["qwen3-8b"]
    n = memory.mesh_train_depth(full, 2, 2, 71 * 2**30, 48.0)
    assert 0 < n < full.n_layers
    assert max(memory.mesh_train_bytes(dataclasses.replace(
        full, n_layers=n), 2, 2, 48.0)) <= 71 * 2**30
    assert max(memory.mesh_train_bytes(dataclasses.replace(
        full, n_layers=n + 1), 2, 2, 48.0)) > 71 * 2**30
    assert flops.mfu(989e12, 1.0, cards=4) == 0.25


def test_training_cli_on_a_mesh(tmp_path):
    """``--smoke --data 1 --model 2 --device cpu --steps 3 --ckpt-every
    1`` (at a short sequence): two rank processes, rank 0's JSON line; the
    same command again resumes from the step-3 checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--data", "1", "--model", "2", "--device", "cpu",
           "--seq-len", "32", "--batch", "4", "--steps", "3",
           "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "ck")]
    outs = []
    for _ in range(2):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=300, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append((out.stdout,
                     json.loads(out.stdout.strip().splitlines()[-1])))
    (so1, res), (so2, res2) = outs
    assert res["steps"] == 3 and res["device"] == "cpu"
    assert (res["data"], res["model"], res["rank"]) == (1, 2, 0)
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["last_loss"])
    assert res["start_step"] == 0 and "restored checkpoint" not in so1
    assert res2["start_step"] == 3 and res2["steps"] == 3
    assert so2.count("restored checkpoint @ step 3") == 1
    assert (tmp_path / "ck" / "step_00000006").is_dir()
