"""The recurrent families on a within-pod ("data", "model") mesh, on the
CPU: the new collectives' adjoints, mamba's fused [u | z] projection
held as the reference's shard, the mixers under the mesh against one
process, each rank's shard layout against the reference's, the K/V
heads fewer than "model" held as the reference splits them (training
starcoder2-3b on (1, 4)), the refusals and the depth reckoning.  Served
against the live reference: tests/test_torch_mesh_recurrent_serve.py;
trained: tests/test_torch_mesh_recurrent_train_<D>x<M>.py; checkpoints:
tests/test_torch_mesh_recurrent_ckpt.py.

* On gloo ranks (``spawn_mesh``, ``file://`` rendezvous; the rank code
  is ``tests/torch_mesh_recurrent_ranks.py``) on (1, 2), (2, 1), (2, 2)
  and (1, 4), in f64 against one process's autograd within ``F64_RTOL``
  = 1e-12 of the largest entry: ``uz_exchange`` (the reference's
  contiguous part of [u | z] to the rank's [u_m | z_m], its inverse the
  adjoint) and ``gather_model_cols`` (an all-gather whose adjoint is a
  reduce-scatter).
* SMOKE falcon-mamba-7b's ``in_proj`` shard on each rank is the
  reference's: on (1, 2) rank 0 holds all of u (the first d_inner
  columns), rank 1 all of z.
* ``mamba_mix`` and ``rec_mix`` on each rank's shards and batch block,
  f64 weights and inputs (the scans run in f32, as the models run them:
  ``MIX_RTOL`` = 1e-6), few tokens and many (mamba exchanges the
  projection's columns, then the weight's): the output and the gradients
  of x and of every leaf against the unsharded mixer.
* Each rank's shard shapes are the reference's ``param_shardings()``
  fitted to the mesh (its nested region's local shapes) and
  ``check_reference_shards`` passes, for both families on (1, 2), (2, 1)
  and (2, 2) and falcon-mamba-7b on (1, 4).
* SMOKE starcoder2-3b (two K/V heads) on (1, 4): wk / wv hold the
  reference's column shard of the seeded model; the loss and each
  rank's reduced gradient against the unsharded model (f32, ``F32_RTOL``
  = 1e-5); a ``local`` Trainer step's loss, grad norm and parameter
  shards against one process's.
* The refusals: recurrentgemma-2b (10 heads) on model = 4 and
  falcon-mamba-7b (d_inner 8192) on model = 3, naming the config; the
  encoder-decoder and the VLM naming ROADMAP Queue 1 item 2b.
* ``launch.memory.mesh_train_bytes`` counts a rank's scan bytes over its
  d_inner / M channels, and ``mesh_train_depth`` the layers that fit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models.registry import build_model as jbuild
from repro_torch import tree as T
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import memory
from repro_torch.models import shardctx as SC
from repro_torch.models.mamba import mamba_mix
from repro_torch.models.registry import build_model
from repro_torch.models.rglru import rec_mix
from test_torch_models import _key
from test_torch_shard import _ref_local_shape
from torch_mesh_recurrent_ranks import (KV_ARCH, MIXER_ARCH, MIXER_CASES,
                                        XC, XF, collective_inputs,
                                        mixer_inputs, recurrent_rank)
from torch_mesh_train_ranks import model_case, run_config

MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
F64_RTOL = 1e-12
MIX_RTOL = 1e-6
F32_RTOL = 1e-5
ids = [f"{d}x{m}" for d, m in MESHES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_mesh
    tmp = tmp_path_factory.mktemp("mesh_recurrent")
    return {mesh: spawn_mesh(recurrent_rank, *mesh, "cpu",
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


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_uz_exchange_and_its_adjoint(ranks, mesh):
    """Rank m gets u's and z's m-th blocks from the reference's part m of
    [u | z]; the gradient on its part is the cotangent's in the
    reference's columns (the exchange is a permutation)."""
    M = mesh[1]
    a = collective_inputs(M)
    u, z = np.split(a["uz"], 2, axis=-1)
    for r in ranks[mesh]:
        m = r["coords"][1]
        blk = slice(m * XC, (m + 1) * XC)
        close(r["halves"][0], np.concatenate([u[..., blk], z[..., blk]], -1),
              F64_RTOL, "y")
        close(r["halves"][1], a["uz_c"][..., m * 2 * XC:(m + 1) * 2 * XC],
              F64_RTOL, "dx")


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_gather_model_cols_and_its_adjoint(ranks, mesh):
    """Each rank's columns of the product of the gathered input; the
    gradient on its part the reduce-scatter of every rank's."""
    M = mesh[1]
    a = collective_inputs(M)
    x, w = _leaf(a["g"]), torch.from_numpy(a["gw"])
    y = x @ w
    (gx,) = torch.autograd.grad((y * torch.from_numpy(a["g_c"])).sum(), x)
    for r in ranks[mesh]:
        m = r["coords"][1]
        close(r["gather_cols"][0], y.detach()[..., m * XF:(m + 1) * XF],
              F64_RTOL, "y")
        close(r["gather_cols"][1], gx[..., m * XC:(m + 1) * XC], F64_RTOL,
              "dx")


def test_in_proj_shard_is_the_references_u_half_on_1x2(ranks):
    """On (1, 2) rank 0 holds the first d_inner columns of the seeded
    in_proj — all of u — and rank 1 all of z; on every mesh each rank's
    shard is the reference's contiguous block."""
    cfg = SMOKE_ARCHS["falcon-mamba-7b"]
    Di = cfg.d_inner
    assert Di == 128
    whole = build_model(cfg, device="cpu")
    whole.init_params(torch.Generator().manual_seed(3))
    w = whole.blocks["slot0"]["in_proj"].detach().numpy()
    got = {tuple(r["coords"]): r["in_proj"] for r in ranks[(1, 2)]}
    np.testing.assert_array_equal(got[0, 0][0], w[..., :Di])
    np.testing.assert_array_equal(got[0, 1][0], w[..., Di:])
    for mesh in MESHES:
        D, M = mesh
        for r in ranks[mesh]:
            d, m = r["coords"]
            rows = slice(d * cfg.d_model // D, (d + 1) * cfg.d_model // D)
            cols = slice(m * 2 * Di // M, (m + 1) * 2 * Di // M)
            shard, index = r["in_proj"]
            assert index == (slice(None), rows, cols)
            np.testing.assert_array_equal(shard, w[:, rows, cols])


def _whole_mixer(kind, B, S):
    a = mixer_inputs(kind, B, S)
    cfg = SMOKE_ARCHS[MIXER_ARCH[kind]]
    p = {k: _leaf(v) for k, v in a["p"].items()}
    x = _leaf(a["x"])
    y = (mamba_mix if kind == "mamba" else rec_mix)(p, x, cfg)
    names = sorted(p)
    grads = torch.autograd.grad((y * torch.from_numpy(a["c"])).sum(),
                                [x] + [p[k] for k in names])
    return y.detach(), grads[0], dict(zip(names, grads[1:]))


@pytest.mark.parametrize("case", MIXER_CASES,
                         ids=[f"{k}-{b}x{s}" for k, b, s in MIXER_CASES])
@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_mixer_on_the_mesh_matches_one_process(ranks, mesh, case):
    """The mixer's output and gradients on each rank's shards and batch
    block against the unsharded mixer (f64; the scans in f32)."""
    y, gx, gp = _whole_mixer(*case)
    B = case[1]
    for r in ranks[mesh]:
        d, m = r["coords"]
        rows = SC.ShardCtx(*mesh, d, m).batch_slice(B)
        res = r["mixers"][case]
        close(res["y"], y[rows], MIX_RTOL, "y")
        close(res["x"], gx[rows], MIX_RTOL, "dx")
        for k, g in gp.items():
            close(res[k], g[res["index"][k]], MIX_RTOL, k)


SHAPE_CASES = ([(a, m) for a in ("falcon-mamba-7b", "recurrentgemma-2b")
                for m in MESHES[:3]] + [("falcon-mamba-7b", (1, 4))])


@pytest.mark.parametrize("arch,mesh", SHAPE_CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in SHAPE_CASES])
def test_shards_are_the_references_and_train(arch, mesh):
    """Each rank's parameter shapes are the reference's
    ``param_shardings()`` fitted to the mesh, and the Trainer takes the
    layout (``check_reference_shards``)."""
    D, M = mesh
    jm = jbuild(J_SMOKE[arch])
    specs = {_key(p): x for p, x in jax.tree_util.tree_flatten_with_path(
        jm.param_shardings(), is_leaf=lambda x: isinstance(x, P))[0]}
    shapes = {_key(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_flatten_with_path(jm.param_specs())[0]}
    run = run_config(arch)
    for d in range(D):
        for m in range(M):
            tm = build_model(run.model, run, device="meta",
                             ctx=SC.ShardCtx(D, M, d, m))
            got = {T.path_str(q): tuple(x.shape)
                   for q, x in T.leaves_with_path(tm.param_tree())}
            assert set(got) == set(shapes)
            for k, full in shapes.items():
                assert got[k] == _ref_local_shape(
                    specs[k], full, {"data": D, "model": M}), k
                assert tm.full_shapes[k] == full
            tm.check_reference_shards()


def test_kv_heads_fewer_than_model_train_on_1x4(ranks):
    """SMOKE starcoder2-3b's two K/V heads over four "model" ranks: wk /
    wv hold the reference's column shard (half a head each) of the
    seeded model; the loss and the reduced gradients equal the unsharded
    model's, and a ``local`` Trainer step's loss, grad norm and
    parameters one process's."""
    cfg = SMOKE_ARCHS[KV_ARCH]
    assert cfg.n_kv_heads == 2
    whole, batch = model_case(KV_ARCH, 32, 4, None)
    params = {T.path_str(q): x.detach().numpy()
              for q, x in T.leaves_with_path(whole.param_tree())}
    loss = whole.loss(batch)
    leaves = T.leaves(whole.param_tree())
    grads = dict(zip(sorted(params), (g.numpy() for g in torch.autograd.grad(
        loss, leaves))))
    run = run_config(KV_ARCH)
    tr = Trainer(build_model(run.model, run, device="cpu"), run)
    state = tr.init_state(0)
    b = {k: torch.from_numpy(v) for k, v in
         TokenPipeline(tr.model, run.shape, seed=0).host_batch(0).items()}
    state, met = tr.step(state, b, tr.default_plan(), "local")
    stepped = {T.path_str(q): x.detach().numpy()
               for q, x in T.leaves_with_path(state["params"])}
    w = cfg.n_kv_heads * cfg.head_dim // 4
    for r in ranks[(1, 4)]:
        m = r["coords"][1]
        res = r["kv"]
        for k, (shard, index) in res["kv"].items():
            assert index[-1] == slice(m * w, (m + 1) * w), k
            assert shard.shape[-1] == w < cfg.head_dim
            np.testing.assert_array_equal(shard, params[k][index])
        want = float(loss.detach())
        assert abs(res["loss"] - want) <= F32_RTOL * abs(want)
        for k, (g, index) in res["grads"].items():
            close(g, grads[k][index], F32_RTOL, k)
        for k in ("loss", "grad_norm"):
            assert abs(res["step"][k] - float(met[k])) <= F32_RTOL * abs(
                float(met[k])), k
        for k, (p, index) in res["params"].items():
            close(p, stepped[k][index], F32_RTOL, k)


def test_meshes_that_do_not_split_refuse():
    """recurrentgemma-2b's 10 heads over model = 4, falcon-mamba-7b's
    d_inner over model = 3: ``ValueError`` naming the config."""
    with pytest.raises(ValueError, match="recurrentgemma-2b.*heads"):
        build_model(ARCHS["recurrentgemma-2b"], device="meta",
                    ctx=SC.ShardCtx(1, 4))
    with pytest.raises(ValueError, match="falcon-mamba-7b.*d_inner"):
        build_model(ARCHS["falcon-mamba-7b"], device="meta",
                    ctx=SC.ShardCtx(1, 3))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_frontend_families_refuse_a_mesh_naming_item_2b(arch):
    with pytest.raises(NotImplementedError, match="Queue 1, item 2b"):
        build_model(SMOKE_ARCHS[arch], device="meta", ctx=SC.ShardCtx(1, 2))


def test_mesh_train_bytes_count_a_ranks_scan_channels():
    """A rank's reckoned bytes: its parameters at the bytes per parameter
    plus, for mamba, its scan's (B / D, d_inner / M) share; the depth
    that fits is the deepest whose largest rank does."""
    cfg = dataclasses.replace(ARCHS["falcon-mamba-7b"], n_layers=2)
    counts = memory.mesh_param_counts(cfg, 1, 4)
    scan = memory.mesh_scan_bytes(cfg, 1, 4, 8, 1024)
    assert scan == memory.mesh_scan_bytes(cfg, 1, 1, 8, 1024) // 4 > 0
    assert memory.mesh_scan_bytes(cfg, 2, 1, 8, 1024) == \
        memory.mesh_scan_bytes(cfg, 1, 1, 8, 1024) // 2
    assert memory.mesh_scan_bytes(ARCHS["recurrentgemma-2b"], 1, 2, 8,
                                  1024) == 0
    got = memory.mesh_train_bytes(cfg, 1, 4, 52.0, batch=8, seq=1024)
    assert got == [n * 52.0 + scan for n in counts]
    assert memory.mesh_train_bytes(cfg, 1, 4, 52.0) == [n * 52.0
                                                         for n in counts]
    limit = max(got)
    assert memory.mesh_train_depth(
        dataclasses.replace(cfg, n_layers=64), 1, 4, limit, 52.0,
        batch=8, seq=1024) == 2
