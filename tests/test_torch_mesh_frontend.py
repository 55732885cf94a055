"""The encoder-decoder and the VLM on a within-pod ("data", "model")
mesh, on the CPU: the cross-attention under the mesh against one
process, each rank's shard layout against the reference's, the models'
gradients against the unsharded models (the VLM's patches blocked over
"data"), the refusals and the depth reckoning.  Served against the live
reference: tests/test_torch_mesh_frontend_serve.py; trained:
tests/test_torch_mesh_frontend_train_<D>x<M>.py; checkpoints:
tests/test_torch_mesh_frontend_ckpt.py.

* On gloo ranks (``spawn_mesh``, ``file://`` rendezvous; the rank code
  is ``tests/torch_mesh_frontend_ranks.py``) on (1, 2), (2, 1), (2, 2)
  and (1, 4), in f64 against one process's autograd within ``F64_RTOL``
  = 1e-12 of the largest entry: ``cross_attn_apply`` on the rank's
  query heads and K/V columns and its batch block — with as many K/V
  heads as heads, and with one (fewer than "model": each rank gathers it
  whole from the column parts) — its output, the cross cache it writes
  (the rank's K/V heads), ``cross_attn_decode`` over that cache, and the
  gradients of x, of the encoder's output and of every weight shard.
* SMOKE seamless-m4t-medium (batch 3: D = 2 does not split it) and
  llava-next-mistral-7b (batch 4, its 8 patches blocked with the tokens)
  from a seeded f32 model, fed seeded non-zero frames / patches: the
  loss and each rank's reduced gradient shard against the unsharded
  model's within ``F32_RTOL`` = 1e-5 of the leaf's largest entry.
* Each rank's shard shapes are the reference's ``param_shardings()``
  fitted to the mesh, for both archs on (1, 2), (2, 1), (2, 2) and
  (1, 4), and ``check_reference_shards`` passes; the encoder's and the
  decoder's stacked leaves are FSDP-sharded on D = 2, the norms and
  ``enc_norm`` summed over "data".
* The refusals that remain: a mesh whose "model" does not divide the
  heads raises ``ValueError`` naming the config (also
  tests/test_torch_mesh_recurrent.py and tests/test_torch_shard.py).
* ``launch.memory.mesh_train_depth`` cuts both of seamless's stacks.
"""

from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models.registry import build_model as jbuild
from repro_torch import tree as T
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.launch import memory
from repro_torch.models import layers as L
from repro_torch.models import shardctx as SC
from repro_torch.models.registry import build_model
from test_torch_models import _key
from test_torch_shard import _ref_local_shape
from torch_mesh_frontend_ranks import (CROSS_KV, MODEL_CASES, cross_cfg,
                                       cross_inputs, frontend_rank)
from torch_mesh_train_ranks import model_case, run_config

FRONTEND = ("seamless-m4t-medium", "llava-next-mistral-7b")
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
F64_RTOL = 1e-12
F32_RTOL = 1e-5
ids = [f"{d}x{m}" for d, m in MESHES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_mesh
    tmp = tmp_path_factory.mktemp("mesh_frontend")
    return {mesh: spawn_mesh(frontend_rank, *mesh, "cpu",
                             init_method=f"file://{tmp / f'{mesh[0]}x{mesh[1]}'}",
                             threads=1, timeout=600)
            for mesh in MESHES}


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, (what, err, tol)


def _whole_cross(kv, rows):
    """The unsharded layer on the batch rows ``rows``."""
    a, cfg = cross_inputs(kv), cross_cfg(kv)
    a = {k: (v[rows] if k in ("x", "mem", "c", "x1") else v)
         for k, v in a.items()}
    p = {k: torch.from_numpy(a[k]).requires_grad_(True)
         for k in ("wq", "wk", "wv", "wo")}
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    mem = torch.from_numpy(a["mem"]).requires_grad_(True)
    cache = {k: torch.zeros((x.shape[0], mem.shape[1], kv, cfg.head_dim),
                            dtype=torch.float64) for k in ("k", "v")}
    y = L.cross_attn_apply(p, x, mem, cfg, cache=cache)
    with torch.no_grad():
        y1 = L.cross_attn_decode(p, torch.from_numpy(a["x1"]), cache, cfg)
    names = sorted(p)
    g = torch.autograd.grad((y * torch.from_numpy(a["c"])).sum(),
                            [x, mem] + [p[k] for k in names])
    return (y.detach(), y1, {k: c.detach() for k, c in cache.items()},
            g[0], g[1], dict(zip(names, g[2:])))


@pytest.mark.parametrize("kv", CROSS_KV, ids=[f"kv{k}" for k in CROSS_KV])
@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_cross_attention_on_the_mesh_matches_one_process(ranks, mesh, kv):
    """Each rank's output (prefill and one decode step over the cache it
    wrote), its cache (its K/V heads: one head per rank where the K/V
    heads are fewer than "model", the head its query heads share) and
    the gradients of x, mem and its weight shards against the unsharded
    layer on the rank's batch block (f64)."""
    cfg = cross_cfg(kv)
    D, M = mesh
    for r in ranks[mesh]:
        d, m = r["coords"]
        ctx = SC.ShardCtx(D, M, d, m)
        y, y1, cache, gx, gmem, gw = _whole_cross(
            kv, ctx.batch_slice(cross_inputs(kv)["x"].shape[0]))
        res = r["cross"][kv]
        close(res["y"], y, F64_RTOL, "y")
        close(res["y1"], y1, F64_RTOL, "decode")
        n = L.kv_heads_local(cfg, ctx)
        h0 = (m * n if kv % M == 0 else m // (M // kv))
        for k, c in cache.items():
            close(res["cache"][k], c[:, :, h0:h0 + n], F64_RTOL, k)
        close(res["x"], gx, F64_RTOL, "dx")
        close(res["mem"], gmem, F64_RTOL, "dmem")
        for k, g in gw.items():
            close(res["grads"][k], g[res["index"][k]], F64_RTOL, k)
        if kv < M:
            # wk / wv: a column part of the one head, as the reference
            assert res["index"]["wk"][-1] != slice(None)


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in
                                                   MODEL_CASES])
@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_model_gradients_match_the_unsharded_model(ranks, mesh, case):
    """The loss and every rank's reduced gradient shard (the encoder's
    leaves, ``enc_norm`` and the cross-attention's too) against the
    unsharded model on seeded non-zero frames / patches (f32)."""
    model, batch = model_case(*case)
    assert all(float(batch[k].abs().max()) > 0 for k in model.float_inputs)
    leaves = T.leaves(model.param_tree())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves)
    paths = [T.path_str(q) for q, _ in T.leaves_with_path(model.param_tree())]
    want = dict(zip(paths, grads))
    for r in ranks[mesh]:
        got_loss, got = r["models"][case]
        want_loss = float(loss.detach())
        assert abs(got_loss - want_loss) <= F32_RTOL * abs(want_loss)
        assert set(got) == set(want)
        for p, (g, idx) in got.items():
            close(g, want[p].numpy()[idx], F32_RTOL, p)


@pytest.mark.parametrize("arch", FRONTEND)
@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_shards_are_the_references_and_train(arch, mesh):
    """Each rank's parameter shapes are the reference's
    ``param_shardings()`` fitted to the mesh, the Trainer takes the
    layout (``check_reference_shards``); on D = 2 every stacked weight
    of both stacks is FSDP-sharded and the rest summed over "data"."""
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
                fsdp = D > 1 and "data" in specs[k]
                assert (k in tm._fsdp) == fsdp, k
                assert ("data" in tm.grad_reduce_axes(k)) == (
                    D > 1 and not fsdp), k
            tm.check_reference_shards()
    if arch == "seamless-m4t-medium" and D > 1:
        assert {k.split("/")[0] for k in tm._fsdp} == {"enc_blocks",
                                                       "dec_blocks"}


@pytest.mark.parametrize("arch", FRONTEND)
def test_meshes_that_do_not_split_the_heads_refuse(arch):
    """A mesh whose "model" does not divide the heads: ``ValueError``
    naming the config and its heads, on (2, 3) as on (1, 3)."""
    for cfg in (SMOKE_ARCHS[arch], ARCHS[arch]):
        with pytest.raises(ValueError, match=f"{cfg.name}.*heads"):
            build_model(cfg, device="meta", ctx=SC.ShardCtx(2, 3, 1, 2))


def test_mesh_train_depth_cuts_both_stacks():
    """seamless-m4t-medium's depth on a mesh cuts the encoder with the
    decoder: the depth whose (6 + 6)-layer model just fits is 6."""
    cfg = ARCHS["seamless-m4t-medium"]
    cut = memory.cut_depth(cfg, 6)
    assert (cut.n_layers, cut.n_enc_layers) == (6, 6)
    limit = max(memory.mesh_train_bytes(cut, 2, 2, 52.0))
    assert memory.mesh_train_depth(cfg, 2, 2, limit, 52.0) == 6
    assert memory.mesh_train_depth(cfg, 2, 2, limit - 1, 52.0) == 5
    assert memory.cut_depth(ARCHS["qwen3-8b"], 4).n_enc_layers == 0
    enc = [sum(p.numel() for p in build_model(
        memory.cut_depth(cfg, n), device="meta").enc_blocks.parameters())
        for n in (3, 6)]
    assert enc[1] == 2 * enc[0]
