"""The port's within-pod ("data", "model") mesh against the reference's,
on the CPU: the fit rule, the MoE's per-block dispatch, and the dense
and MoE models served on D x M meshes.

* The fit rule (``norm_spec`` / ``fit_spec``) case by case against the
  reference's, which is pure: it is given a stand-in mesh (axis names
  and sizes), no devices.  Each rank's parameter shapes against the
  reference's ``param_shardings()`` fitted to the mesh (K/V heads fewer
  than "model" too: the port holds the reference's column shard and
  gathers the rank's head at use).
* The reference runs in two subprocesses on ("data", "model") meshes of
  ``--xla_force_host_platform_device_count=4`` host devices, as its
  ``Server(mesh=)`` runs (``jax.jit`` under ``use_shard_ctx(mesh)``);
  the port as one gloo process per rank (``spawn_mesh``, ``file://``
  rendezvous), both fed the same seeded numpy inputs and the reference's
  weights, in f32:

  - ``moe_apply`` at capacity factor 1.25 on (1, 2), (2, 1) and (2, 2),
    within 1e-5; tokens routed towards two experts, so that blocks drop
    pairs, and the blocked answer differs from the unsharded one;
  - SMOKE qwen3-8b, gemma2-9b, starcoder2-3b, qwen3-moe-30b-a3b and
    dbrx-132b on (1, 2) and (2, 2), and starcoder2-3b on (1, 4) (two
    K/V heads over four ranks): the prefill's and 4 teacher-forced
    decode steps' vocab-sharded logits and the caches' shards within
    1e-5 relative; the ``Server``'s greedy tokens (4 requests of 16 / 12
    / 9 / 16 tokens, 6 new) equal to the reference ``Server(mesh=)``'s
    and identical on every rank.

* ``init_model(ctx=)``'s shards equal slices of the unsharded seeded
  model, bit for bit; the serve CLI on a (1, 2) mesh prints its JSON
  keys; a mesh that does not split the heads is refused (the published
  encoder-decoder and VLM too), and a Trainer of pods x a mesh (the
  dense and MoE families train there: tests/test_torch_mesh_train*.py;
  the recurrent families serve and train there:
  tests/test_torch_mesh_recurrent*.py; the frontend families:
  tests/test_torch_mesh_frontend*.py).
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models import shardctx as JS
from repro.models.registry import build_model as jbuild
from repro_torch.configs import ARCHS as PUBLISHED, SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as TM
from repro_torch.models import shardctx as S
from repro_torch.models.registry import build_model as tbuild
from test_torch_models import _key, close_f32, ref_flat
from torch_mesh_ranks import (B, CACHE, MOE_ARCH, NEW, PROMPTS, SP, STEPS,
                              port_flat, port_rank, requests)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
#: (D, M) meshes of the MoE case and of the models
MOE_MESHES = ((1, 2), (2, 1), (2, 2))
ARCHS = ("qwen3-8b", "gemma2-9b", "starcoder2-3b", "qwen3-moe-30b-a3b",
         "dbrx-132b")
MODEL_CASES = ([(a, (1, 2)) for a in ARCHS] + [(a, (2, 2)) for a in ARCHS]
               + [("starcoder2-3b", (1, 4))])
#: the MoE case: (2, 16) tokens of one qwen3-moe SMOKE layer
MOE_SHAPE = (2, 16)


# ---------------------------------------------------------------------------
# the fit rule
# ---------------------------------------------------------------------------

FIT_CASES = [
    # (spec, shape, sizes, exclude)
    ((("pod", "data"), "model", None), (1, 16, 64), {"data": 2, "model": 2},
     ()),                                     # a batch of 1 over data = 2
    ((("pod", "data"), "model", None), (4, 1, 64), {"data": 2, "model": 2},
     ()),                                     # S = 1 over model
    ((None, "data", "model"), (2, 3072, 256), {"data": 1, "model": 4},
     ()),                                     # KV * Dh = 2 * 128 over 4
    ((None, "data", "model"), (2, 48, 6), {"data": 2, "model": 4}, ()),
    (("pod", ("pod", "data"), "model"), (4, 4, 4), {"data": 2, "model": 2},
     ()),                                     # no "pod" axis
    ((("data", "model"), None), (6, 3), {"data": 2, "model": 2}, ()),
    ((("data", "model"), None), (8, 3), {"data": 2, "model": 2}, ()),
    ((("pod", "data"), "model", None), (4, 16, 64), {"data": 2, "model": 2},
     ("data",)),                              # exclude
    ((("pod", "data"), "model"), (4, 16), {"data": 2, "model": 2},
     ("data", "model")),
]


def _stand_in(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


@pytest.mark.parametrize("case", FIT_CASES, ids=range(len(FIT_CASES)))
def test_fit_rule_matches_reference(case):
    spec, shape, sizes, exclude = case
    mesh = _stand_in(sizes)
    want = JS.fit_spec(P(*spec), shape, mesh, exclude)
    assert S.fit_spec(spec, shape, sizes, exclude) == tuple(want)
    assert S.norm_spec(spec, sizes, exclude) == tuple(
        JS.norm_spec(P(*spec), mesh, exclude))


def test_axis_range_units():
    assert S.axis_range(12, 2, 1) == (6, 12)
    assert S.axis_range(7, 2, 1) == (0, 7)          # fit: replicated
    assert [S.axis_range(256, 4, m, units=2) for m in range(4)] == [
        (0, 128), (0, 128), (128, 256), (128, 256)]
    assert S.axis_range(256, 2, 1, units=4) == (128, 256)
    with pytest.raises(ValueError):
        S.axis_range(6 * 16, 4, 0, units=6)


def _ref_local_shape(spec, shape, sizes):
    out = []
    for n, ax in zip(shape, tuple(JS.fit_spec(spec, shape,
                                              _stand_in(sizes)))):
        axes = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
        out.append(n // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("arch,mesh", MODEL_CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in MODEL_CASES])
def test_shard_shapes_match_reference_shardings(arch, mesh):
    """Each rank's parameter shapes are the reference's
    ``param_shardings()`` fitted to the mesh, wk / wv where the K/V heads
    are fewer than "model" (starcoder2-3b on (1, 4)) too."""
    D, M = mesh
    jm = jbuild(J_SMOKE[arch])
    specs = {_key(p): x for p, x in jax.tree_util.tree_flatten_with_path(
        jm.param_shardings(), is_leaf=lambda x: isinstance(x, P))[0]}
    shapes = {_key(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_flatten_with_path(jm.param_specs())[0]}
    cfg = SMOKE_ARCHS[arch]
    for d in range(D):
        for m in range(M):
            tm = tbuild(cfg, device="meta", ctx=S.ShardCtx(D, M, d, m))
            got = {k: tuple(v.shape) for k, v in
                   port_flat(tm.param_tree()).items()}
            assert set(got) == set(shapes)
            for k, full in shapes.items():
                want = _ref_local_shape(specs[k], full,
                                        {"data": D, "model": M})
                assert got[k] == want, (k, got[k], want)


# ---------------------------------------------------------------------------
# the reference on meshes, in a subprocess
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import moe as JM
from repro.models.registry import build_model
from repro.models.shardctx import use_shard_ctx

ARGS = json.loads(sys.argv[1])
IN = dict(np.load(ARGS["inputs"]))
out = {}


def mesh_of(D, M):
    return make_mesh((D, M), ("data", "model"), devices=jax.devices()[:D * M])


cfg = SMOKE_ARCHS[ARGS["moe_arch"]]
p = {k[4:]: jnp.asarray(v) for k, v in IN.items() if k.startswith("moe/")}
x = jnp.asarray(IN["moe_x"])
# a fresh function per mesh: jit's cache does not see the ambient mesh
if ARGS["moe_meshes"]:
    out["moe/none"] = np.asarray(jax.jit(
        lambda p, x: JM.moe_apply(p, x, cfg))(p, x))
for D, M in ARGS["moe_meshes"]:
    with use_shard_ctx(mesh_of(D, M)):
        out[f"moe/{D}x{M}"] = np.asarray(jax.jit(
            lambda p, x: JM.moe_apply(p, x, cfg))(p, x))

B, SP, CACHE, STEPS = ARGS["tf"]
toks = jnp.asarray(IN["tf_tokens"])
for arch, (D, M) in ARGS["models"]:
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tag = f"{arch}/{D}x{M}"
    server = jserve.Server(model, CACHE, B, mesh=mesh_of(D, M))
    logits, caches = server._prefill(params, {"tokens": toks[:, :SP]}, CACHE)
    out[f"{tag}/logits0"] = np.asarray(logits)
    out.update({f"{tag}/prefill/{s}/{kv}": np.asarray(c)
                for s, kvs in caches.items() for kv, c in kvs.items()})
    for i in range(STEPS):
        logits, caches = server._decode(params, caches, jnp.int32(SP + i),
                                        toks[:, SP + i:SP + i + 1])
        out[f"{tag}/logits{i + 1}"] = np.asarray(logits)
    out.update({f"{tag}/decode/{s}/{kv}": np.asarray(c)
                for s, kvs in caches.items() for kv, c in kvs.items()})
    reqs = [jserve.Request(i, IN["prompt%d" % i], ARGS["new"])
            for i in range(len(ARGS["prompts"]))]
    done = server.serve(params, reqs)
    out[f"{tag}/tokens"] = np.asarray([r.out_tokens for r in done])
np.savez(ARGS["out"], **out)
print("REF_OK")
"""


def _moe_inputs():
    """One MoE layer's weights and (2, 16, 64) tokens, skewed towards
    expert 0 so that capacity drops pairs, differently in every block
    layout of ``MOE_MESHES``."""
    cfg = SMOKE_ARCHS[MOE_ARCH]
    D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    r = np.random.RandomState(7)
    router = r.randn(D, E).astype(np.float32) * 0.02
    bias = r.randn(D).astype(np.float32)
    router[:, 0] += 0.05 * bias / np.linalg.norm(bias)
    p = {"router": router,
         "w_gate": (r.randn(E, D, Fe) / np.sqrt(D)).astype(np.float32),
         "w_up": (r.randn(E, D, Fe) / np.sqrt(D)).astype(np.float32),
         "w_down": (r.randn(E, Fe, D) / np.sqrt(Fe)).astype(np.float32)}
    x = (r.randn(*MOE_SHAPE, D) + 0.5 * bias).astype(np.float32)
    return p, x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz dict, {(D, M): [port result per rank]}): the
    reference's subprocesses run while the port's meshes do."""
    from repro_torch.launch.mesh import spawn_mesh
    tmp = tmp_path_factory.mktemp("shard")
    moe_p, moe_x = _moe_inputs()
    tf_tokens = np.random.RandomState(1).randint(
        0, 256, size=(B, SP + STEPS)).astype(np.int32)
    inputs = {f"moe/{k}": v for k, v in moe_p.items()}
    inputs.update({"moe_x": moe_x, "tf_tokens": tf_tokens})
    inputs.update({f"prompt{r.rid}": r.prompt for r in requests()})
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    # two reference processes side by side: the (2, 2) models, the rest
    halves = ([c for c in MODEL_CASES if c[1] == (2, 2)],
              [c for c in MODEL_CASES if c[1] != (2, 2)])
    procs = []
    for i, models in enumerate(halves):
        args = {"inputs": str(tmp / "in.npz"), "out": str(tmp / f"ref{i}.npz"),
                "moe_arch": MOE_ARCH, "moe_meshes": MOE_MESHES if i else (),
                "tf": (B, SP, CACHE, STEPS), "models": models,
                "prompts": PROMPTS, "new": NEW}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        weights = {a: ref_flat(jbuild(dataclasses.replace(
            J_SMOKE[a], dtype="float32")).init(jax.random.PRNGKey(0)))
            for a in ARCHS}
        port = {}
        meshes = sorted({m for _, m in MODEL_CASES} | set(MOE_MESHES))
        for D, M in meshes:
            archs = [a for a, m in MODEL_CASES if m == (D, M)]
            port[D, M] = spawn_mesh(
                port_rank, D, M, "cpu",
                args=((moe_p, moe_x), archs, weights, tf_tokens),
                init_method=f"file://{tmp / f'store{D}x{M}'}", threads=1,
                timeout=600)
        ref = {}
        for i, proc in enumerate(procs):
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "REF_OK" in so, se[-3000:]
            ref.update(np.load(tmp / f"ref{i}.npz"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, port


def _block(D, M, d, m, shape, vocab=False):
    """The index of rank (d, m)'s block of a (B, ...) result: the batch
    over "data" (fit rule), the last dimension over "model" where
    ``vocab``."""
    idx = [S.ShardCtx(D, M, d, m).batch_slice(shape[0])]
    idx += [slice(None)] * (len(shape) - 1)
    if vocab:
        idx[-1] = slice(*S.axis_range(shape[-1], M, m))
    return tuple(idx)


@pytest.mark.parametrize("mesh", MOE_MESHES,
                         ids=[f"{d}x{m}" for d, m in MOE_MESHES])
def test_moe_apply_matches_reference_on_mesh(runs, mesh):
    """Every rank's block of the port's ``moe_apply`` equals the
    reference's on the same mesh within 1e-5 (f32, capacity factor
    1.25); the blocks drop pairs of their own, so the mesh's answer is
    not the unsharded one, and it is ``moe_apply_blocked``'s."""
    ref, port = runs
    D, M = mesh
    want = ref[f"moe/{D}x{M}"]
    cfg = SMOKE_ARCHS[MOE_ARCH]
    assert cfg.capacity_factor == 1.25
    for r in port[mesh]:
        d, m = r["coords"]
        close_f32(r["moe"], want[_block(D, M, d, m, want.shape)], RTOL)
    assert np.abs(want - ref["moe/none"]).max() > 1e-2
    p, x = _moe_inputs()
    blocked = TM.moe_apply_blocked({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   torch.from_numpy(x), cfg, D, M)
    close_f32(blocked.numpy(), want, RTOL)


def _model_case_ids():
    return [f"{a}-{d}x{m}" for a, (d, m) in MODEL_CASES]


@pytest.mark.parametrize("arch,mesh", MODEL_CASES, ids=_model_case_ids())
def test_prefill_decode_match_reference_on_mesh(runs, arch, mesh):
    """Each rank's vocab-sharded logits of its batch block (prefill and
    4 teacher-forced decode steps) and its caches' shards (batch block,
    K/V heads) against the reference on the same mesh, f32 within 1e-5
    relative."""
    ref, port = runs
    D, M = mesh
    tag = f"{arch}/{D}x{M}"
    cfg = SMOKE_ARCHS[arch]
    for r in port[mesh]:
        d, m = r["coords"]
        res = r["models"][arch]
        for i in range(STEPS + 1):
            want = ref[f"{tag}/logits{i}"]
            close_f32(res[f"logits{i}"],
                      want[_block(D, M, d, m, want.shape, vocab=True)], RTOL)
        kv = S.axis_range(cfg.n_kv_heads * cfg.head_dim, M, m,
                          units=cfg.n_kv_heads)
        heads = slice(kv[0] // cfg.head_dim, kv[1] // cfg.head_dim)
        for stage in ("prefill", "decode"):
            for key, got in res[stage].items():
                want = ref[f"{tag}/{stage}/{key}"]     # (L, B, S, KV, Dh)
                rows = S.ShardCtx(D, M, d, m).batch_slice(want.shape[1])
                close_f32(got, want[:, rows, :, heads], RTOL)


@pytest.mark.parametrize("arch,mesh", MODEL_CASES, ids=_model_case_ids())
def test_server_tokens_match_reference_on_mesh(runs, arch, mesh):
    """The port's Server on the mesh: every rank holds the reference
    ``Server(mesh=)``'s greedy tokens (f32)."""
    ref, port = runs
    want = ref[f"{arch}/{mesh[0]}x{mesh[1]}/tokens"].tolist()
    for r in port[mesh]:
        assert r["models"][arch]["tokens"] == want


@pytest.mark.parametrize("arch,mesh", MODEL_CASES, ids=_model_case_ids())
def test_seeded_shards_equal_the_unsharded_model(runs, arch, mesh):
    """``init_model(ctx=)``: each rank's Parameters are slices of the
    unsharded model of the same seed, bit for bit, and their bytes the
    shards' sizes."""
    _, port = runs
    whole = port_flat(tserve.init_model(SMOKE_ARCHS[arch], "cpu",
                                         seed=5).param_tree())
    for r in port[mesh]:
        res = r["models"][arch]
        n = 0
        for k, got in res["seeded"].items():
            want = whole[k].detach().float().numpy()[res["index"][k]]
            np.testing.assert_array_equal(got.view(np.int32),
                                          np.ascontiguousarray(want)
                                          .view(np.int32), err_msg=k)
            n += got.size * 2                                   # bf16
        assert res["param_bytes"] == n


# ---------------------------------------------------------------------------
# the CLI and the refusals
# ---------------------------------------------------------------------------


def test_serve_cli_on_a_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--data", "1", "--model", "2",
         "--prompt-len", "16", "--new-tokens", "4", "--requests", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert set(json.loads(lines[-1])) == {"requests", "tokens", "wall_s",
                                          "tok_per_s"}
    assert sum(ln.startswith("rank ") for ln in lines) == 2


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_unported_families_refuse_a_mesh(arch):
    """Every family builds on a mesh (the encoder-decoder and the VLM
    since ROADMAP Queue 1 item 2b): what is refused is a mesh that does
    not split the published config's heads (16 / 32 over model = 3),
    ``ValueError`` naming the config, from ``init_model`` as from the
    registry."""
    cfg = PUBLISHED[arch]
    with pytest.raises(ValueError, match=f"{cfg.name}.*heads"):
        tserve.init_model(cfg, "cpu", ctx=S.ShardCtx(1, 3))
    assert tbuild(cfg, device="meta", ctx=S.ShardCtx(1, 4)).ctx.M == 4


def test_a_mesh_that_does_not_split_the_heads_raises():
    with pytest.raises(ValueError, match="does not divide"):
        tbuild(SMOKE_ARCHS["qwen3-8b"], device="meta", ctx=S.ShardCtx(1, 3))


def test_training_under_a_mesh_raises():
    """Every family trains under a mesh (the VLM, the dense stack behind
    its vision stub, since ROADMAP Queue 1 item 2b: its forward takes the
    patches under a (1, 1) context and differentiates), on a two-tier
    fleet of such meshes too (item 3b): the Trainer builds, its scheduler
    hierarchical."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.models.transformer import DenseTransformer
    cfg = SMOKE_ARCHS["llava-next-mistral-7b"]
    model = DenseTransformer(cfg, device="cpu", ctx=S.ShardCtx(1, 1))
    patches = torch.ones((2, cfg.n_patches, cfg.d_model))
    x = model(torch.zeros((2, 8), dtype=torch.int32), patch_embs=patches)
    assert x.shape == (2, cfg.n_patches + 8, cfg.d_model) and x.requires_grad
    pods = type("Pods", (), {"size": 4, "n_edge": 2})()
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 8, 4, "train"))
    tr = Trainer(model, run, pods=pods)
    assert tr.scheduler.hier_enabled and tr.scheduler.n_cross == 2
