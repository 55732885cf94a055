"""Serving the encoder-decoder and the VLM on a ("data", "model") mesh
against the live reference, on the CPU: SMOKE seamless-m4t-medium and
llava-next-mistral-7b (f32, the reference's weights) on (1, 2) and
(2, 2), fed seeded non-zero frames / patch embeddings (zero frames make
the encoder's output exactly 0: a served run with zero inputs gates
nothing).

The reference runs ``Server(mesh=)``'s jitted prefill and decode
(``jax.jit`` under ``use_shard_ctx(mesh)``) in a subprocess on 4 forced
XLA host devices; the port as one gloo process per rank (``spawn_mesh``;
the rank code is ``tests/torch_mesh_frontend_ranks.py``).  Checked per
rank, within 1e-5 relative:

* the prefill's and 4 teacher-forced decode steps' vocab-sharded logits
  of its batch block — the VLM's decode at n_patches + t, its ring
  holding the patches too (R8: the reference's ``Server`` loop starts at
  t; its model-level calls are given the port's positions here) — and
  its caches' shards: the batch block and the rank's K/V heads, the
  encoder-decoder's ``cross`` K/V of the frames too (the reference's
  ``cache_shardings`` splits the caches' sequence over "model" instead,
  a layout of XLA's that changes no value);
* the ``Server``'s greedy tokens (4 requests, 6 new; zero frontend
  inputs, as both packages serve): seamless's equal to the reference
  ``Server(mesh=)``'s, the VLM's to the port's unsharded Server's (the
  reference's decodes from the wrong position, R8), on every rank;
* the seeded shards slices of the unsharded seeded model, bit for bit.

ROADMAP P13, settled here: the bf16 gap between a (1, 2) mesh's logits
and the unsharded model's for SMOKE falcon-mamba-7b and
recurrentgemma-2b (bf16 compute on the reference's f32 weights, the
same seeded tokens), the reference's own (its mesh against its
unsharded model) and the port's (its ranks against its one process).
The port's must not exceed twice the reference's; both are printed.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import shardctx as S
from repro_torch.models.registry import build_model as tbuild
from test_torch_models import close_f32, ref_flat
from test_torch_shard import ROOT, _block
from torch_mesh_frontend_ranks import (GAP_ARCHS, SERVE_ARCHS, gap_logits,
                                       frontend_serve_rank)
from torch_mesh_ranks import (B, CACHE, NEW, PROMPTS, SP, STEPS, port_flat,
                              requests)

RTOL = 1e-5
MESHES = ((1, 2), (2, 2))
CASES = [(a, m) for m in MESHES for a in SERVE_ARCHS]
#: the port's bf16 mesh gap at most this many times the reference's
GAP_FACTOR = 2.0

REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models.registry import build_model
from repro.models.shardctx import sharding_for
from jax.sharding import PartitionSpec as PSpec

A = json.loads(sys.argv[1])
IN = dict(np.load(A["inputs"]))
B, SP, CACHE, STEPS = A["tf"]
toks = jnp.asarray(IN["tf_tokens"])
out = {}


def mesh_of(D, M):
    return make_mesh((D, M), ("data", "model"), devices=jax.devices()[:D * M])


def run(model, params, mesh, inputs, P):
    # the prefill and the teacher-forced decode steps at the port's
    # positions (after the VLM's patches)
    server = jserve.Server(model, P + CACHE, B, mesh=mesh)
    logits, caches = server._prefill(
        params, {"tokens": toks[:, :SP], **inputs}, P + CACHE)
    rows = [np.asarray(logits)]
    for i in range(STEPS):
        logits, caches = server._decode(params, caches,
                                        jnp.int32(P + SP + i),
                                        toks[:, SP + i:SP + i + 1])
        rows.append(np.asarray(logits))
    return server, rows, caches


for arch, (D, M) in A["models"]:
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    P = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    inputs = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in IN.items()
              if k.startswith(arch + "/")}
    tag = f"{arch}/{D}x{M}"
    server, rows, caches = run(model, params, mesh_of(D, M), inputs, P)
    out.update({f"{tag}/logits{i}": r for i, r in enumerate(rows)})
    out.update({f"{tag}/cache/{s}/{kv}": np.asarray(c)
                for s, kvs in caches.items() for kv, c in kvs.items()})
    reqs = [jserve.Request(i, IN["prompt%d" % i], A["new"])
            for i in range(len(A["prompts"]))]
    out[f"{tag}/tokens"] = np.asarray(
        [r.out_tokens for r in server.serve(params, reqs)])
for arch in A["gap"]:
    # bf16 compute on the f32 masters, no mesh and the (1, 2) mesh with
    # the weights placed as its param_shardings name them (a mesh run
    # given whole weights computes their products unsharded)
    model = build_model(SMOKE_ARCHS[arch])
    params = model.init(jax.random.PRNGKey(0))
    mesh = mesh_of(1, 2)
    spec = jax.tree.map(lambda sp, x: sharding_for(mesh, sp, x.shape),
                        model.param_shardings(), params,
                        is_leaf=lambda x: isinstance(x, PSpec))
    placed = jax.device_put(params, spec)
    for name, mesh, p in (("mesh", mesh, placed), ("none", None, params)):
        rows = run(model, p, mesh, {}, 0)[1]
        out[f"gap/{arch}/{name}"] = np.stack(
            [np.asarray(r[:, -1], np.float32) for r in rows])
np.savez(A["out"], **out)
print("REF_OK")
"""


def _frontend_inputs(arch):
    """Seeded non-zero float inputs of ``B`` sequences of ``SP`` tokens
    (numpy, f32)."""
    model = tbuild(SMOKE_ARCHS[arch], device="meta")
    r = np.random.RandomState(13)
    return {k: r.randn(*d).astype(np.float32)
            for k, d in model.frontend_shapes(B, SP).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz dict, {(D, M): [port result per rank]}, the
    reference's weights)."""
    from repro_torch.launch.mesh import spawn_mesh
    tmp = tmp_path_factory.mktemp("mesh_frontend_serve")
    tf_tokens = np.random.RandomState(1).randint(
        0, 256, size=(B, SP + STEPS)).astype(np.int32)
    fin = {a: _frontend_inputs(a) for a in SERVE_ARCHS}
    inputs = {"tf_tokens": tf_tokens}
    inputs.update({f"{a}/{k}": v for a, d in fin.items()
                   for k, v in d.items()})
    inputs.update({f"prompt{r.rid}": r.prompt for r in requests()})
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = []
    for i, mesh in enumerate(MESHES):
        args = {"inputs": str(tmp / "in.npz"), "out": str(tmp / f"ref{i}.npz"),
                "tf": (B, SP, CACHE, STEPS),
                "models": [(a, mesh) for a in SERVE_ARCHS],
                "gap": GAP_ARCHS if i == 0 else (),
                "prompts": PROMPTS, "new": NEW}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        weights = {a: ref_flat(jbuild(dataclasses.replace(
            J_SMOKE[a], dtype="float32")).init(jax.random.PRNGKey(0)))
            for a in SERVE_ARCHS + GAP_ARCHS}
        port = {mesh: spawn_mesh(
            frontend_serve_rank, *mesh, "cpu",
            args=(weights, tf_tokens, fin, mesh == (1, 2)),
            init_method=f"file://{tmp / f'store{mesh[0]}x{mesh[1]}'}",
            threads=1, timeout=600) for mesh in MESHES}
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
    return ref, port, weights


def _cache_index(arch, shape, ctx):
    """The rank's part of a reference cache (n, B, S, KV, Dh): its batch
    block and its K/V heads."""
    cfg = SMOKE_ARCHS[arch]
    kv = S.axis_range(cfg.n_kv_heads * cfg.head_dim, ctx.M, ctx.m,
                      units=cfg.n_kv_heads)
    heads = slice(kv[0] // cfg.head_dim, kv[1] // cfg.head_dim)
    return (slice(None), ctx.batch_slice(shape[1]), slice(None), heads)


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_prefill_decode_match_reference_on_mesh(runs, arch, mesh):
    """Each rank's vocab-sharded logits of its batch block (prefill on
    seeded non-zero frames / patches and 4 teacher-forced decode steps)
    and its caches' shards against the reference on the same mesh, f32
    within 1e-5 relative."""
    ref, port, _ = runs
    D, M = mesh
    tag = f"{arch}/{D}x{M}"
    for r in port[mesh]:
        d, m = r["coords"]
        ctx = S.ShardCtx(D, M, d, m)
        res = r["models"][arch]
        for i in range(STEPS + 1):
            want = ref[f"{tag}/logits{i}"]
            close_f32(res[f"logits{i}"],
                      want[_block(D, M, d, m, want.shape, vocab=True)], RTOL)
        want_keys = {k[len(f"{tag}/cache/"):] for k in ref
                     if k.startswith(f"{tag}/cache/")}
        assert set(res["decode"]) == want_keys
        for key, got in res["decode"].items():
            want = ref[f"{tag}/cache/{key}"]
            close_f32(got, want[_cache_index(arch, want.shape, ctx)], RTOL)
        if arch == "seamless-m4t-medium":
            # the cross K/V of the frames: written by prefill, non-zero
            cross = res["prefill"]["cross/k"]
            np.testing.assert_array_equal(cross, res["decode"]["cross/k"])
            assert float(np.abs(cross).min()) > 0


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_server_tokens_match_reference_on_mesh(runs, arch, mesh):
    """Zero frontend inputs, as both packages serve (a smoke run, not a
    gate of the encoder): the encoder-decoder's tokens are the reference
    ``Server(mesh=)``'s; the VLM's, which the reference decodes from the
    wrong position (R8), the port's unsharded Server's."""
    ref, port, weights = runs
    if arch == "seamless-m4t-medium":
        want = ref[f"{arch}/{mesh[0]}x{mesh[1]}/tokens"].tolist()
    else:
        tm = tbuild(dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32"),
                    device="cpu")
        convert.params_from_reference(weights[arch], tm)
        want = [q.out_tokens for q in tserve.Server(
            tm, tm.n_prefix + CACHE, B).serve(requests())]
    for r in port[mesh]:
        assert r["models"][arch]["tokens"] == want


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_seeded_shards_equal_the_unsharded_model(runs, arch, mesh):
    """``init_model(ctx=)``: each rank's Parameters (both stacks of the
    encoder-decoder) are slices of the unsharded model of the same seed,
    bit for bit."""
    _, port, _ = runs
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


@pytest.mark.parametrize("arch", GAP_ARCHS)
def test_recurrent_bf16_mesh_gap_is_the_references(runs, arch):
    """ROADMAP P13: in bf16 compute the port's (1, 2) logits differ from
    its unsharded model's by no more than ``GAP_FACTOR`` times what the
    reference's (1, 2) mesh differs from its own unsharded model, on the
    same weights and tokens."""
    import torch
    ref, port, weights = runs
    want = gap_logits(None, arch, weights[arch],
                      torch.from_numpy(np.random.RandomState(1).randint(
                          0, 256, size=(B, SP + STEPS)).astype(np.int32)))
    port_gap = 0.0
    for r in port[(1, 2)]:
        d, m = r["coords"]
        got = r["gap"][arch]
        cols = slice(*S.axis_range(want.shape[-1], 2, m))
        port_gap = max(port_gap, float(np.abs(got - want[..., cols]).max()))
    ref_gap = float(np.abs(ref[f"gap/{arch}/mesh"]
                           - ref[f"gap/{arch}/none"]).max())
    scale = float(np.abs(ref[f"gap/{arch}/none"]).max())
    print(f"{arch}: bf16 max |mesh - unsharded| on (1, 2): reference "
          f"{ref_gap:.6g}, port {port_gap:.6g} (largest logit {scale:.4g})")
    assert port_gap <= GAP_FACTOR * ref_gap, (port_gap, ref_gap)
