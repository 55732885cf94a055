"""Serving the recurrent families on a ("data", "model") mesh against the
live reference, on the CPU: SMOKE falcon-mamba-7b and recurrentgemma-2b
(f32, the reference's weights) on (1, 2) and (2, 2).

The reference runs its ``Server(mesh=)`` (``jax.jit`` under
``use_shard_ctx(mesh)``; ``tests/test_torch_shard.py``'s script) in two
subprocesses on 4 forced XLA host devices, one per mesh; the port as one
gloo process per rank (``spawn_mesh``; the rank code is
``tests/torch_mesh_ranks.py``'s ``serve_rank``).  Checked per rank: the
prefill's and 4 teacher-forced decode steps' vocab-sharded logits of its
batch block and its caches' shards — the conv carry and the scan state
over the rank's channels (mamba's d_inner, the RG-LRU's width), the
local attention's one K/V head whole on every rank — within 1e-5
relative; the ``Server``'s greedy tokens (4 requests, 6 new) equal to
the reference's on every rank; the seeded shards slices of the unsharded
seeded model, bit for bit.
"""
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
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import shardctx as S
from test_torch_models import close_f32, ref_flat
from test_torch_shard import REF_SCRIPT, ROOT, _block, _moe_inputs
from torch_mesh_ranks import (B, CACHE, NEW, PROMPTS, SP, STEPS, port_flat,
                              requests, serve_rank)

RTOL = 1e-5
ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
MESHES = ((1, 2), (2, 2))
CASES = [(a, m) for m in MESHES for a in ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz dict, {(D, M): [port result per rank]})."""
    from repro_torch.launch.mesh import spawn_mesh
    tmp = tmp_path_factory.mktemp("mesh_rec_serve")
    tf_tokens = np.random.RandomState(1).randint(
        0, 256, size=(B, SP + STEPS)).astype(np.int32)
    # the script reads its MoE case's inputs, which no mesh here runs
    moe_p, moe_x = _moe_inputs()
    inputs = {f"moe/{k}": v for k, v in moe_p.items()}
    inputs.update({"moe_x": moe_x, "tf_tokens": tf_tokens})
    inputs.update({f"prompt{r.rid}": r.prompt for r in requests()})
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = []
    for i, mesh in enumerate(MESHES):
        args = {"inputs": str(tmp / "in.npz"), "out": str(tmp / f"ref{i}.npz"),
                "moe_arch": "qwen3-moe-30b-a3b", "moe_meshes": (),
                "tf": (B, SP, CACHE, STEPS),
                "models": [(a, mesh) for a in ARCHS],
                "prompts": PROMPTS, "new": NEW}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        weights = {a: ref_flat(jbuild(dataclasses.replace(
            J_SMOKE[a], dtype="float32")).init(jax.random.PRNGKey(0)))
            for a in ARCHS}
        port = {mesh: spawn_mesh(
            serve_rank, *mesh, "cpu", args=(ARCHS, weights, tf_tokens),
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
    return ref, port


def _cache_index(key, shape, ctx):
    """The rank's part of a reference cache (n, B, ...): its batch block,
    and its channels (the conv carry's last dimension, the scan state's
    third); a K/V cache's one head is whole on every rank."""
    idx = [slice(None), ctx.batch_slice(shape[1])] + [slice(None)] * (
        len(shape) - 2)
    kind = key.rsplit("/", 1)[-1]
    if kind in ("conv", "h"):
        dim = len(shape) - 1 if kind == "conv" or len(shape) == 3 else 2
        idx[dim] = slice(*S.axis_range(shape[dim], ctx.M, ctx.m))
    return tuple(idx)


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_prefill_decode_match_reference_on_mesh(runs, arch, mesh):
    """Each rank's vocab-sharded logits of its batch block (prefill and
    4 teacher-forced decode steps) and its caches' shards against the
    reference on the same mesh, f32 within 1e-5 relative."""
    ref, port = runs
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
        for stage in ("prefill", "decode"):
            assert set(res[stage]) == {k[len(f"{tag}/{stage}/"):]
                                       for k in ref if k.startswith(
                                           f"{tag}/{stage}/")}
            for key, got in res[stage].items():
                want = ref[f"{tag}/{stage}/{key}"]
                close_f32(got, want[_cache_index(key, want.shape, ctx)],
                          RTOL)


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_server_tokens_match_reference_on_mesh(runs, arch, mesh):
    ref, port = runs
    want = ref[f"{arch}/{mesh[0]}x{mesh[1]}/tokens"].tolist()
    for r in port[mesh]:
        assert r["models"][arch]["tokens"] == want


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_seeded_shards_equal_the_unsharded_model(runs, arch, mesh):
    """``init_model(ctx=)``: each rank's Parameters are slices of the
    unsharded model of the same seed, bit for bit."""
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
