"""The port's side of ``tests/test_torch_shard.py``: one rank of a
("data", "model") mesh, run in a process of its own by ``spawn_mesh``.
Kept apart from the test file, which imports JAX: a spawned rank imports
this module by name and nothing of the reference."""
import dataclasses

import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as TM
from repro_torch.models import shardctx as S
from repro_torch.models.registry import build_model as tbuild

#: the teacher-forced run: batch, prompt, cache, decode steps
B, SP, CACHE, STEPS = 4, 16, 22, 4
#: the Server's requests: prompt lengths, new tokens (one server batch)
PROMPTS, NEW = (16, 12, 9, 16), 6
#: the MoE case: one layer of this SMOKE config (E = 8, K = 2, d 64,
#: Fe 32) at its capacity factor 1.25
MOE_ARCH = "qwen3-moe-30b-a3b"


def port_flat(tree) -> dict:
    """A port parameter tree's leaves by path."""
    return {T.path_str(p): x for p, x in T.leaves_with_path(tree)}


def requests():
    return tserve.make_requests(PROMPTS, NEW, 256, seed=3)


def port_rank(ctx, moe_in, archs, weights, tf_tokens):
    """One rank: the MoE case, then each arch's teacher-forced run, its
    Server and its seeded init; each rank's shards of the results."""
    torch.set_num_threads(1)
    p, x = moe_in
    out = {"coords": (ctx.d, ctx.m), "models": {}}
    cfg = SMOKE_ARCHS[MOE_ARCH]
    e = S.axis_range(cfg.n_experts, ctx.M, ctx.m)
    dd = S.axis_range(cfg.d_model, ctx.D, ctx.d)
    ep = {"router": torch.from_numpy(p["router"])}
    for k in ("w_gate", "w_up"):
        ep[k] = torch.from_numpy(p[k][e[0]:e[1], dd[0]:dd[1]])
    ep["w_down"] = torch.from_numpy(p["w_down"][e[0]:e[1], :, dd[0]:dd[1]])
    # the layer's FSDP gather, as the model's, then the layer
    ep = {k: (v if k == "router" else ctx.all_gather(
        v, "data", 1 if k != "w_down" else 2)) for k, v in ep.items()}
    xl = torch.from_numpy(x)[ctx.batch_slice(x.shape[0])]
    with S.use_shard_ctx(ctx):
        out["moe"] = TM.moe_apply(ep, xl, cfg).numpy()
    toks = torch.from_numpy(tf_tokens)
    for arch in archs:
        out["models"][arch] = serve_arch(ctx, arch, weights[arch], toks)
    return out


def serve_arch(ctx, arch, weights, toks) -> dict:
    """One arch on the rank, from the reference's ``weights`` (f32): the
    prefill's and ``STEPS`` teacher-forced decode steps' logits and
    caches of its shards, its Server's tokens and its seeded init's
    shards, their indices and bytes."""
    model = tbuild(dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32"),
                   device="cpu", ctx=ctx)
    convert.params_from_reference(convert.shard_params(weights, model),
                                  model)
    r = {}
    with torch.inference_mode():
        logits, caches = model.prefill(toks[:, :SP], CACHE)
        r["logits0"] = logits.numpy()
        r["prefill"] = {f"{s}/{kv}": c.numpy().copy()
                        for s, kvs in caches.items()
                        for kv, c in kvs.items()}
        for i in range(STEPS):
            logits, caches = model.decode_step(
                caches, SP + i, toks[:, SP + i:SP + i + 1])
            r[f"logits{i + 1}"] = logits.numpy()
        r["decode"] = {f"{s}/{kv}": c.numpy() for s, kvs in
                       caches.items() for kv, c in kvs.items()}
    done = tserve.Server(model, CACHE, B, ctx=ctx).serve(requests())
    r["tokens"] = [q.out_tokens for q in done]
    seeded = tserve.init_model(SMOKE_ARCHS[arch], "cpu", seed=5, ctx=ctx)
    r["seeded"] = {k: v.detach().float().numpy() for k, v in
                   port_flat(seeded.param_tree()).items()}
    r["index"] = {k: seeded.shard_index(k) for k in r["seeded"]}
    r["param_bytes"] = sum(q.numel() * q.element_size()
                           for q in seeded.parameters())
    return r


def serve_rank(ctx, archs, weights, tf_tokens):
    """One rank: :func:`serve_arch` of each arch."""
    torch.set_num_threads(1)
    toks = torch.from_numpy(tf_tokens)
    return {"coords": (ctx.d, ctx.m),
            "models": {a: serve_arch(ctx, a, weights[a], toks)
                       for a in archs}}
