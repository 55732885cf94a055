"""The port's side of ``tests/test_torch_mesh_frontend.py``: one rank of
a ("data", "model") mesh, run in a process of its own by ``spawn_mesh``.
Kept apart from the test file, which imports JAX: a spawned rank imports
this module by name and nothing of the reference.  Results cross the
process boundary as numpy arrays and Python values."""
import types

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import shardctx as SC
from torch_mesh_train_ranks import model_grads

#: the cross-attention cases (f64): batch, queries, memory positions,
#: d_model, heads, head size; K/V heads of each case — as many as the
#: heads, and one (fewer than "model" on every mesh with M > 1: each
#: rank gathers the head whole from the ranks' column parts; its XDH
#: columns split over M = 4, as a published head's 128 do)
XB, XS, XM, XD, XH, XDH = 4, 3, 5, 8, 4, 4
CROSS_KV = (4, 1)
#: the model cases: (arch, seq, batch, capacity factor) — batch 3 does
#: not split over D = 2, so each data rank takes the whole batch
MODEL_CASES = (("seamless-m4t-medium", 32, 3, None),
               ("llava-next-mistral-7b", 32, 4, None))


def cross_cfg(kv: int):
    return types.SimpleNamespace(name=f"cross-{kv}", n_heads=XH,
                                 n_kv_heads=kv, head_dim=XDH, qk_norm=False)


def cross_inputs(kv: int) -> dict:
    """Seeded f64 weights of one cross-attention layer, its queries'
    input x, the memory and the cotangents of prefill's and of one
    decode step's output, whole (numpy)."""
    r = np.random.RandomState(23 + kv)
    return {"wq": r.randn(XD, XH * XDH), "wk": r.randn(XD, kv * XDH),
            "wv": r.randn(XD, kv * XDH), "wo": r.randn(XH * XDH, XD),
            "x": r.randn(XB, XS, XD), "mem": r.randn(XB, XM, XD),
            "c": r.randn(XB, XS, XD), "x1": r.randn(XB, 1, XD)}


def cross_index(ctx, kv: int) -> dict:
    """Each weight's index of the rank's shard: the model's
    ``attn_shardings`` without its FSDP dimension (no "data" split)."""
    cfg, shapes = cross_cfg(kv), {}
    for k, spec in L.attn_shardings(cfg).items():
        spec = tuple(None if ax == "data" else ax for ax in spec)
        shapes[k] = ctx.local_index(spec, cross_inputs(kv)[k].shape)
    return shapes


def _grads(loss, *xs):
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


def cross_grads(ctx, kv: int) -> dict:
    """``cross_attn_apply`` on the rank's shards and batch block, writing
    a cache of the rank's K/V heads, then ``cross_attn_decode`` over that
    cache: both outputs, the cache, and the gradients of the prefill's
    block loss — x's, mem's and each weight's shard."""
    a, cfg = cross_inputs(kv), cross_cfg(kv)
    index = cross_index(ctx, kv)
    rows = ctx.batch_slice(XB)
    p = {k: torch.from_numpy(np.ascontiguousarray(a[k][i]))
         .requires_grad_(True) for k, i in index.items()}
    x = torch.from_numpy(a["x"][rows]).requires_grad_(True)
    mem = torch.from_numpy(a["mem"][rows]).requires_grad_(True)
    heads = L.kv_heads_local(cfg, ctx)
    cache = {k: torch.zeros((x.shape[0], XM, heads, XDH),
                            dtype=torch.float64) for k in ("k", "v")}
    with SC.use_shard_ctx(ctx):
        y = L.cross_attn_apply(p, x, mem, cfg, cache=cache)
        with torch.no_grad():
            y1 = L.cross_attn_decode(p, torch.from_numpy(a["x1"][rows]),
                                     cache, cfg)
    names = sorted(p)
    grads = _grads((y * torch.from_numpy(a["c"][rows])).sum(), x, mem,
                   *(p[k] for k in names))
    return {"y": y.detach().numpy(), "y1": y1.numpy(),
            "cache": {k: c.detach().numpy() for k, c in cache.items()},
            "x": grads[0], "mem": grads[1], "index": index,
            "grads": dict(zip(names, grads[2:]))}


def frontend_rank(ctx):
    """One rank: each cross-attention case, then each model case's loss
    and reduced gradients."""
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float32)
    return {"coords": (ctx.d, ctx.m),
            "cross": {kv: cross_grads(ctx, kv) for kv in CROSS_KV},
            "models": {c: model_grads(ctx, *c) for c in MODEL_CASES}}


#: the served archs and the recurrent archs of the bf16 gap (ROADMAP
#: P13): their SMOKE configs in bf16 compute on f32 masters
SERVE_ARCHS = ("seamless-m4t-medium", "llava-next-mistral-7b")
GAP_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")


def gap_logits(ctx, arch, weights, toks) -> np.ndarray:
    """``arch``'s bf16 logits (f32 numpy) on ``ctx``'s mesh (None: one
    process) from the reference's f32 ``weights``: the prefill's last
    position and ``STEPS`` teacher-forced decode steps, (STEPS + 1, B, V)
    of the rank's batch block and vocabulary part."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models.registry import build_model
    from torch_mesh_ranks import CACHE, SP, STEPS
    model = build_model(dataclasses.replace(SMOKE_ARCHS[arch],
                                            dtype="bfloat16"),
                        device="cpu", ctx=ctx)
    if ctx is not None:
        weights = convert.shard_params(weights, model)
    convert.params_from_reference(weights, model)
    rows = []
    with torch.inference_mode():
        logits, caches = model.prefill(toks[:, :SP], CACHE)
        rows.append(logits[:, -1])
        for i in range(STEPS):
            logits, caches = model.decode_step(caches, SP + i,
                                               toks[:, SP + i:SP + i + 1])
            rows.append(logits[:, -1])
    return torch.stack(rows).float().numpy()


def frontend_serve_rank(ctx, weights, tf_tokens, inputs, gap):
    """One rank: each served arch's teacher-forced run on seeded
    non-zero frontend inputs, Server and seeded init
    (``torch_mesh_ranks.serve_arch``); then, where ``gap``, each
    recurrent arch's bf16 logits (:func:`gap_logits`)."""
    from torch_mesh_ranks import serve_arch
    torch.set_num_threads(1)
    toks = torch.from_numpy(tf_tokens)
    out = {"coords": (ctx.d, ctx.m),
           "models": {a: serve_arch(ctx, a, weights[a], toks, inputs[a])
                      for a in SERVE_ARCHS}}
    if gap:
        out["gap"] = {a: gap_logits(ctx, a, weights[a], toks)
                      for a in GAP_ARCHS}
    return out
