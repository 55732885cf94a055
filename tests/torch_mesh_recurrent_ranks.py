"""The port's side of ``tests/test_torch_mesh_recurrent.py``: one rank of
a ("data", "model") mesh, run in a process of its own by ``spawn_mesh``.
Kept apart from the test file, which imports JAX: a spawned rank imports
this module by name and nothing of the reference.  Results cross the
process boundary as numpy arrays and Python values."""
import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import shardctx as SC
from repro_torch.models.mamba import (mamba_mix, ssm_layer_shapes,
                                      ssm_layer_shardings)
from repro_torch.models.registry import build_model
from repro_torch.models.rglru import rec_mix, rec_shapes, rec_shardings
from torch_mesh_train_ranks import model_case, run_config

#: the collectives' case: batch, sequence, channels a rank's part of
#: the fused [u | z] (2 * M * C columns) or of the gathered dimension
#: (M * C), and the product's columns (f64)
XB, XS, XC, XF = 2, 3, 4, 6
#: the mixers' cases: (mixer, batch, sequence) — fewer tokens than
#: d_model = 64 and more
MIXER_CASES = (("mamba", 2, 16), ("mamba", 4, 32), ("rec", 2, 16),
               ("rec", 4, 32))
MIXER_ARCH = {"mamba": "falcon-mamba-7b", "rec": "recurrentgemma-2b"}
#: the arch trained on (1, 4): two K/V heads over four "model" ranks
KV_ARCH = "starcoder2-3b"


def collective_inputs(M: int) -> dict:
    """Seeded f64 inputs of the collective cases on a mesh with M model
    ranks, whole (numpy)."""
    r = np.random.RandomState(5)
    return {"uz": r.randn(XB, XS, 2 * M * XC), "uz_c": r.randn(
        XB, XS, 2 * M * XC), "g": r.randn(XB, XS, M * XC),
        "gw": r.randn(M * XC, M * XF), "g_c": r.randn(XB, XS, M * XF)}


def mixer_inputs(kind: str, B: int, S: int) -> dict:
    """One mixer's seeded f64 weights (the SMOKE config's per-layer
    shapes), its input x (B, S, d_model) and the output's cotangent."""
    cfg = SMOKE_ARCHS[MIXER_ARCH[kind]]
    r = np.random.RandomState(17)
    shapes = ssm_layer_shapes(cfg) if kind == "mamba" else rec_shapes(cfg)
    p = {}
    for k, s in shapes.items():
        if k == "A_log":
            p[k] = np.log(np.arange(1, s[1] + 1.0))[None] + 0.1 * r.randn(*s)
        elif k in ("lam", "D", "norm") or k.startswith(("b_", "conv_b",
                                                         "dt_bias")):
            p[k] = 0.3 * r.randn(*s)
        else:
            p[k] = r.randn(*s) / np.sqrt(s[0])
    p.pop("norm", None)
    return {"p": p, "x": r.randn(B, S, cfg.d_model),
            "c": r.randn(B, S, cfg.d_model)}


def _grads(loss, *xs):
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


def mixer_grads(ctx, kind: str, B: int, S: int) -> dict:
    """The mixer on the rank's shards of the seeded weights (FSDP leaves
    gathered over "data" as the model gathers them) and its batch block:
    its output and the gradients of the block's loss — x's, and each
    leaf's reduced to the rank's shard of the whole gradient (the FSDP
    leaves by the gather's reduce-scatter, the rest summed over "data"),
    with each leaf's index."""
    a = mixer_inputs(kind, B, S)
    cfg = SMOKE_ARCHS[MIXER_ARCH[kind]]
    specs = ssm_layer_shardings() if kind == "mamba" else rec_shardings()
    rows = ctx.batch_slice(B)
    index = {k: ctx.local_index(specs[k], w.shape) for k, w in a["p"].items()}
    leaves = {k: torch.from_numpy(np.ascontiguousarray(w[index[k]]))
              .requires_grad_(True) for k, w in a["p"].items()}
    fsdp = {k: specs[k].index("data") for k, w in a["p"].items()
            if "data" in specs[k] and w.shape[specs[k].index("data")]
            % ctx.D == 0}
    p = {k: SC.gather_data(v, fsdp[k], ctx) if k in fsdp else v
         for k, v in leaves.items()}
    x = torch.from_numpy(a["x"][rows]).requires_grad_(True)
    with SC.use_shard_ctx(ctx):
        y = (mamba_mix if kind == "mamba" else rec_mix)(p, x, cfg)
    names = sorted(leaves)
    grads = _grads((y * torch.from_numpy(a["c"][rows])).sum(), x,
                   *(leaves[k] for k in names))
    out = {"y": y.detach().numpy(), "x": grads[0], "index": index}
    for k, g in zip(names, grads[1:]):
        if k not in fsdp:
            g = ctx.all_reduce_sum(torch.from_numpy(g), "data").numpy()
        out[k] = g
    return out


def recurrent_rank(ctx):
    """One rank: the collectives' outputs and gradients, the SMOKE
    mamba's ``in_proj`` shard, the mixers' cases, and on a (1, 4) mesh
    the K/V-head case (:func:`kv_case`)."""
    torch.set_num_threads(1)
    M, m = ctx.M, ctx.m
    t = {k: torch.from_numpy(v) for k, v in collective_inputs(M).items()}
    out = {"coords": (ctx.d, ctx.m)}
    # the fused [u | z] columns: the reference's contiguous part m in,
    # [u_m | z_m] out; the gradient the cotangent's in the reference's
    # columns
    w = 2 * XC
    x = t["uz"][..., m * w:(m + 1) * w].clone().requires_grad_(True)
    y = SC.uz_exchange(x, ctx)
    c = t["uz_c"]
    cm = torch.cat([c[..., m * XC:(m + 1) * XC],
                    c[..., M * XC + m * XC:M * XC + (m + 1) * XC]], dim=-1)
    out["halves"] = [y.detach().numpy()] + _grads((y * cm).sum(), x)
    # a "model" part gathered whole for the rank's columns of a product
    x = t["g"][..., m * XC:(m + 1) * XC].clone().requires_grad_(True)
    cols = slice(m * XF, (m + 1) * XF)
    y = SC.gather_model_cols(x, -1, ctx) @ t["gw"][:, cols]
    out["gather_cols"] = [y.detach().numpy()] + _grads(
        (y * t["g_c"][..., cols]).sum(), x)
    # the model's in_proj shard: the reference's columns
    mdl = build_model(SMOKE_ARCHS["falcon-mamba-7b"], device="cpu", ctx=ctx)
    mdl.init_params(torch.Generator().manual_seed(3))
    out["in_proj"] = (mdl.blocks["slot0"]["in_proj"].detach().numpy().copy(),
                      mdl.shard_index("blocks/slot0/in_proj"))
    out["mixers"] = {c: mixer_grads(ctx, *c) for c in MIXER_CASES}
    if (ctx.D, ctx.M) == (1, 4):
        out["kv"] = kv_case(ctx)
    return out


def kv_case(ctx) -> dict:
    """SMOKE starcoder2-3b on the rank: its wk / wv shards of the seeded
    model with their indices, the loss and each leaf's reduced gradient
    (``model_grads``' case), and one ``local`` Trainer step from seed 0
    (the Trainer refuses a shard that is not the reference's)."""
    from torch_mesh_train_ranks import model_grads
    model, _ = model_case(KV_ARCH, 32, 4, None, ctx)
    kv = {k: (p.detach().numpy().copy(), model.shard_index(k))
          for k, p in ((T.path_str(q), x) for q, x in
                       T.leaves_with_path(model.param_tree()))
          if k.endswith(("/wk", "/wv"))}
    loss, grads = model_grads(ctx, KV_ARCH, 32, 4, None)
    run = run_config(KV_ARCH)
    tr = Trainer(build_model(run.model, run, device="cpu", ctx=ctx), run)
    state = tr.init_state(0)
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(tr.model, run.shape, seed=0).host_batch(0).items()}
    state, met = tr.step(state, batch, tr.default_plan(), "local")
    params = {T.path_str(q): (x.detach().numpy().copy(),
                              tr.model.shard_index(T.path_str(q)))
              for q, x in T.leaves_with_path(state["params"])}
    return {"kv": kv, "loss": loss, "grads": grads,
            "step": {k: float(v) for k, v in met.items()}, "params": params}
