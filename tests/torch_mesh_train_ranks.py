"""The port's side of the mesh-training tests: one rank of a ("data",
"model") mesh, run in a process of its own by ``spawn_mesh``.  Kept apart
from the test files, which import JAX: a spawned rank imports this module
by name and nothing of the reference."""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.registry import build_model

#: the train shape and learning rate of the Trainer cases (the reference
#: script uses the same)
SEQ, BATCH, LR = 32, 4, 1e-2
#: the step sequences of tests/test_torch_trainer.py
KIND_SEQS = {
    "grad_sync": ["grad_sync"] * 3,
    "local": ["local"] * 3,
    "delta_sync": ["local", "delta_sync"] * 3 + ["local"],
}
#: the state trees whose shards are compared
TREES = ("params", "m", "v", "ace/errors")


def run_config(arch: str) -> RunConfig:
    return RunConfig(model=dataclasses.replace(SMOKE_ARCHS[arch],
                                               dtype="float32"),
                     shape=ShapeConfig("t", SEQ, BATCH, "train"), lr=LR,
                     warmup_steps=1, total_steps=50)


def flat_state(state) -> dict:
    """A port train state's leaves by the reference's paths, numpy."""
    return {k: v.detach().cpu().numpy().copy() for k, v in zip(
        T.reference_leaf_paths(state),
        [leaf for _, leaf in T.reference_leaves_with_path(state)])}


def trainer_rank(ctx, archs, ref_paths):
    """One rank: for each arch, the Trainer from the reference's initial
    state (``ref_paths[arch]``, an npz of its flat ``state0/...``) through
    each sequence of ``KIND_SEQS``; per sequence the metrics of each step
    and the rank's shards of the final state's trees; and the sync-round
    oracle (:func:`sync_oracle`)."""
    torch.set_num_threads(1)
    out = {"coords": (ctx.d, ctx.m), "archs": {}}
    for arch in archs:
        ref = np.load(ref_paths[arch])
        state0 = {k[len("state0/"):]: ref[k] for k in ref.files
                  if k.startswith("state0/")}
        run = run_config(arch)
        tr = Trainer(build_model(run.model, run, device="cpu", ctx=ctx), run,
                     strategy="acesync")
        plan = tr.default_plan()
        r = {"local_sizes": list(tr.local_sizes),
             "level_idx": list(plan.level_idx),
             "bucket_sig": list(plan.bucket_sig),
             "index": {T.path_str(q): tr.model.shard_index(T.path_str(q))
                       for q, _ in T.leaves_with_path(
                           tr.model.param_tree())},
             "seqs": {}, "sync": sync_oracle(tr)}
        pipe = TokenPipeline(tr.model, run.shape, seed=0)
        for name, kinds in KIND_SEQS.items():
            state = convert.state_from_reference(state0, tr)
            mets = []
            for i, kind in enumerate(kinds):
                b = {k: torch.from_numpy(v)
                     for k, v in pipe.host_batch(i).items()}
                state, m = tr.step(state, b, plan, kind)
                mets.append({k: float(v) for k, v in m.items()})
            flat = flat_state(state)
            r["seqs"][name] = {"metrics": mets, "state": {
                k: v for k, v in flat.items()
                if k.startswith(tuple(t + "/" for t in TREES))}}
        out["archs"][arch] = r
    return out


#: the sync-round oracle: the groups round-robin on all 8 ladder rungs,
#: seeded gradients and residuals, gamma
SYNC_GAMMA = 0.9


def seeded_tree(shapes: dict, seed: int, scale: float = 1.0) -> dict:
    """{path: f32 array of the leaf's whole shape}, leaf k drawn from
    ``RandomState(seed + k)`` in sorted-path order (the reference script
    draws the same)."""
    return {p: (np.random.RandomState(seed + k).randn(*shapes[p])
                * scale).astype(np.float32)
            for k, p in enumerate(sorted(shapes))}


def sync_oracle(tr) -> dict:
    """The rank's one-pod ``sync_tree`` on its shards of the seeded
    gradients and residuals under the round-robin plan: {"agg/<path>",
    "err/<path>": shard}."""
    from repro_torch.core import sync as S
    model = tr.model
    full = {T.path_str(q): model.full_shapes[T.path_str(q)]
            for q, _ in T.leaves_with_path(model.param_tree())}
    plan = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.sizes))], (1.0,))

    def shards(seed, scale):
        return T.from_flat_dict({
            p: torch.from_numpy(np.ascontiguousarray(
                a[model.shard_index(p)]))
            for p, a in seeded_tree(full, seed, scale).items()})

    cfg = tr.run.acesync
    agg, err = S.sync_tree(shards(1, 1.0), shards(2, 0.3),
                           tr.exec_plan(plan), gamma=SYNC_GAMMA,
                           block=cfg.topk_block)
    out = {f"agg/{T.path_str(q)}": x.numpy().copy()
           for q, x in T.leaves_with_path(agg)}
    out.update({f"err/{T.path_str(q)}": x.numpy().copy()
                for q, x in T.leaves_with_path(err)})
    return out


# ---------------------------------------------------------------------------
# each collective's adjoint, and the models' gradients, against one process
# ---------------------------------------------------------------------------

#: the collectives' case: batch, sequence, widths (f64)
CB, CS, CD, CF = 4, 6, 8, 12


def collective_inputs() -> dict:
    """Seeded f64 inputs of the collective cases, whole (numpy)."""
    r = np.random.RandomState(11)
    return {"x": r.randn(CB, CS, CD), "wc": r.randn(CD, CF),
            "wr": r.randn(CF, CD), "c": r.randn(CB, CS, CD),
            "emb": r.randn(16, CD), "labels": r.randint(0, 16, (CB, CS)),
            "tokens": r.randint(0, 16, (CB, CS)),
            "a2a": r.randn(4, 8, 3), "a2a_w": r.randn(4, 3),
            "a2a_c": r.randn(4, 8, 3)}


def _grads(loss, *xs):
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


def collective_rank(ctx, cases):
    """One rank: each collective's forward and the gradients of a
    rank-local loss (numpy), the reduce-scatter against the all-reduce,
    and each model case's loss and reduced gradients with their shard
    indices (``cases``: [(arch, seq, batch, capacity factor)])."""
    import types
    from repro_torch.models import layers as L
    from repro_torch.models import shardctx as SC
    torch.set_num_threads(1)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in
         collective_inputs().items()}
    D, M, d, m = ctx.D, ctx.M, ctx.d, ctx.m
    rows = ctx.batch_slice(CB)
    cols = slice(*SC.axis_range(CF, M, m))
    out = {"coords": (d, m)}
    # tensor parallelism: copy in, column- and row-parallel products,
    # reduce out; the rank's batch block
    x = t["x"][rows].clone().requires_grad_(True)
    wc = t["wc"][:, cols].clone().requires_grad_(True)
    wr = t["wr"][cols].clone().requires_grad_(True)
    y = SC.reduce_model(torch.tanh(SC.copy_to_model(x, ctx) @ wc) @ wr, ctx)
    out["tp"] = [y.detach().numpy()] + _grads((y * t["c"][rows]).sum(),
                                              x, wc, wr)
    # FSDP: the weight's rows over "data", gathered; reduce-scatter back
    dr = slice(*SC.axis_range(CD, D, d))
    w = t["wc"][dr].clone().requires_grad_(True)
    x = t["x"][rows]
    y = torch.tanh(x @ SC.gather_data(w, 0, ctx))
    out["fsdp"] = [y.detach().numpy()] + _grads(
        (y * t["c"][rows][..., :1]).sum(), w)
    # the MoE's sequence blocks: split, a replicated weight, gather back
    x = t["x"][rows].clone().requires_grad_(True)
    w = t["wc"][:, :CD].clone().requires_grad_(True)
    y = SC.gather_model(torch.tanh(SC.split_model(x, 1, ctx) @ w), 1, ctx)
    out["blocks"] = [y.detach().numpy()] + _grads(
        (y * t["c"][rows]).sum(), x, w)
    # all_to_all over "model": each rank's own rows, a rank's own weight
    x = (t["a2a"] * (1 + ctx.rank)).clone().requires_grad_(True)
    w = (t["a2a_w"][m] * (1 + ctx.rank)).clone().requires_grad_(True)
    z = SC.all_to_all(x, "model", 0, 1, ctx)
    y = SC.all_to_all(torch.tanh(z * w), "model", 1, 0, ctx)
    out["a2a"] = [y.detach().numpy()] + _grads(
        (y * t["a2a_c"]).sum(), x, w)
    # the vocab-parallel loss and lookup (embedding rows over "model")
    vr = slice(*SC.axis_range(16, M, m))
    cfg = types.SimpleNamespace(final_logit_softcap=30.0,
                                emb_scale_by_dim=False, d_model=CD)
    x = t["x"][rows].clone().requires_grad_(True)
    emb = t["emb"][vr].clone().requires_grad_(True)
    nll = L._chunk_nll(x, emb, t["labels"][rows], cfg, ctx)
    out["xent"] = [nll.detach().numpy()] + _grads(nll, x, emb)
    emb = t["emb"][vr].clone().requires_grad_(True)
    with SC.use_shard_ctx(ctx):
        e = L.embed_lookup(emb, t["tokens"][rows], cfg, torch.float64)
    out["embed"] = [e.detach().numpy()] + _grads((e * t["c"][rows]).sum(),
                                                 emb)
    out["moe"] = moe_grads(ctx)
    # the reduce-scatter against the all-reduce and a slice, f32
    P, k = ctx.world.size, 5
    parts = torch.from_numpy(np.random.RandomState(20 + ctx.rank).randn(
        P, k, 3).astype(np.float32))
    out["rs"] = (ctx.world.reduce_scatter(parts).numpy(),
                 ctx.world.all_reduce_sum(parts)[ctx.rank].numpy())
    out["models"] = {c: model_grads(ctx, *c) for c in cases}
    return out


#: the MoE case: one layer of this SMOKE config (E = 8, K = 2) at its
#: capacity factor 1.25, (2, 16) tokens skewed towards expert 0 so that
#: every block layout drops pairs
MOE_ARCH, MOE_SHAPE = "qwen3-moe-30b-a3b", (2, 16)


def moe_inputs() -> dict:
    cfg = SMOKE_ARCHS[MOE_ARCH]
    D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    r = np.random.RandomState(7)
    router = r.randn(D, E).astype(np.float32) * 0.02
    bias = r.randn(D).astype(np.float32)
    router[:, 0] += 0.05 * bias / np.linalg.norm(bias)
    return {"router": router,
            "w_gate": (r.randn(E, D, Fe) / np.sqrt(D)).astype(np.float32),
            "w_up": (r.randn(E, D, Fe) / np.sqrt(D)).astype(np.float32),
            "w_down": (r.randn(E, Fe, D) / np.sqrt(Fe)).astype(np.float32),
            "x": (r.randn(*MOE_SHAPE, D) + 0.5 * bias).astype(np.float32),
            "c": r.randn(*MOE_SHAPE, D).astype(np.float32)}


def moe_grads(ctx):
    """``moe_apply`` on the rank's experts (over "model") with d_model
    FSDP-gathered over "data", on its batch block: the output and the
    gradients of the block's loss — x's, the router's (partial: the
    rank's tokens), each expert stack's shard (reduce-scattered)."""
    from repro_torch.models import moe as TM
    from repro_torch.models import shardctx as SC
    cfg = SMOKE_ARCHS[MOE_ARCH]
    a = moe_inputs()
    e = slice(*SC.axis_range(cfg.n_experts, ctx.M, ctx.m))
    dd = slice(*SC.axis_range(cfg.d_model, ctx.D, ctx.d))
    rows = ctx.batch_slice(MOE_SHAPE[0])
    leaves = {"router": a["router"], "w_gate": a["w_gate"][e, dd],
              "w_up": a["w_up"][e, dd], "w_down": a["w_down"][e, :, dd]}
    leaves = {k: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(
        True) for k, v in leaves.items()}
    p = {k: (v if k == "router" else SC.gather_data(
        v, 1 if k != "w_down" else 2, ctx)) for k, v in leaves.items()}
    x = torch.from_numpy(a["x"][rows]).requires_grad_(True)
    with SC.use_shard_ctx(ctx):
        y = TM.moe_apply(p, x, cfg)
    names = sorted(leaves)
    grads = _grads((y * torch.from_numpy(a["c"][rows])).sum(), x,
                   *(leaves[k] for k in names))
    return {"y": y.detach().numpy(), "x": grads[0],
            "index": {"e": e, "d": dd, "rows": rows},
            **dict(zip(names, grads[1:]))}


def model_case(arch, seq, batch, cf, ctx=None):
    """(a seeded f32 model of ``arch``'s SMOKE config at capacity factor
    ``cf`` (None: its own) on ``ctx``'s mesh, a seeded batch)."""
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, batch, "train"))
    model = build_model(cfg, run, device="cpu", ctx=ctx)
    model.init_params(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32))
    return model, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def model_grads(ctx, arch, seq, batch, cf):
    """The loss and each leaf's reduced gradient (the rank's shard of the
    global gradient) with its shard index, through the remat layers (on
    the rank's device: drawn on the CPU and moved)."""
    model, batch_ = model_case(arch, seq, batch, cf, ctx)
    if ctx.device.type != "cpu":
        model.to(ctx.device)
        model.device = ctx.device
        batch_ = {k: v.to(ctx.device) for k, v in batch_.items()}
    leaves = T.leaves(model.param_tree())
    loss = model.loss(batch_)
    grads = model.reduce_grads(torch.autograd.grad(loss, leaves))
    paths = [T.path_str(q) for q, _ in T.leaves_with_path(model.param_tree())]
    return float(loss.detach()), {p: (g.cpu().numpy(), model.shard_index(p))
                                  for p, g in zip(paths, grads)}
