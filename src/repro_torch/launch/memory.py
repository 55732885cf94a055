"""Where a train step's memory goes on the card: one architecture at full
width and a given depth, its train step taken apart stage by stage, the
bytes each stage holds and the peak it reaches, per parameter.

    python -m repro_torch.launch.memory --arch qwen3-moe-30b-a3b \
        --layers 1 [--seq-len 1024] [--batch 8] [--out FILE]

Needs a CUDA device.  The session is built as ``chip_smoke.py`` builds
its reduced-depth sessions (the published config with ``n_layers``
replaced) under ``acesync`` with ``replan_every=4``.  The stages are the
``local`` step's own (``Trainer._body_local``): forward and loss, the
backward, the global-norm clip, AdamW; each is run once from the fresh
state with the peak statistics reset before it, and what it leaves
allocated and the peak above that are read with
``torch.cuda.max_memory_allocated``.  Then each step kind (``local``,
``delta_sync``, ``grad_sync`` under the loop's own plan and an
all-rungs ``grad_sync``) runs once through ``Trainer.step`` with its own
peak; ``peak`` is the largest, from which the depth rules reckon.  Prints one JSON object (and writes
it to ``--out`` where given): bytes and bytes per parameter by owner —
the train state, the model's activations kept for the backward, the
gradients, and each stage's transient above what it started from.  For
a recurrent arch (``ssm``, ``hybrid``) also ``scan``, measured first on
the empty card (:func:`scan_memory`): the scan's own memory at the
step's shapes, an owner of its own.

:func:`mesh_weight_bytes` reckons, without allocating anything, the
weight bytes each rank of a ("data", "model") serving mesh holds;
:func:`mesh_train_bytes` a train step's bytes per card on a training
mesh (each rank's parameters at a measured bytes per parameter, and
mamba's scan over the rank's channels, :func:`mesh_scan_bytes`), and
:func:`mesh_train_depth` the most layers whose largest card stays under
a limit.  :func:`step_memory` runs on a mesh rank too: the rank's shards,
its gradients reduced as the trainer reduces them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
from pathlib import Path

import torch


def mesh_weight_bytes(cfg, D: int, M: int,
                      dtype=torch.bfloat16) -> list:
    """The weight bytes each rank (d * M + m) of a (D, M) mesh holds of
    ``cfg``'s model in ``dtype``: its Parameters' shapes, as the model
    shards them, built on the meta device."""
    size = torch.empty((), dtype=dtype).element_size()
    return [n * size for n in mesh_param_counts(cfg, D, M)]


def mesh_param_counts(cfg, D: int, M: int) -> list:
    """The parameters each rank (d * M + m) of a (D, M) mesh holds of
    ``cfg``'s model (1, 1: the whole model), from the meta device."""
    from repro_torch.models.registry import build_model
    from repro_torch.models.shardctx import ShardCtx
    return [sum(p.numel() for p in build_model(
        cfg, device="meta", ctx=ShardCtx(D, M, r // M, r % M)).parameters())
        for r in range(D * M)]


#: the one-chunk (B, Q, d_inner, N) f32 tensors mamba's
#: ``SelectiveScan`` backward holds at its peak, at most (its doc)
SCAN_BWD_CHUNK_TENSORS = 7


def mesh_scan_bytes(cfg, D: int, M: int, batch: int, seq: int) -> int:
    """What mamba's scan adds on a rank of a (D, M) training mesh beside
    its parameters' bytes: the chunk-start states it saves and its
    backward's peak of ``SCAN_BWD_CHUNK_TENSORS`` one-chunk tensors, over
    the rank's batch block and its d_inner / M channels (one layer at a
    time under remat); 0 for a model without that scan."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.flops import scan_start_bytes
    from repro_torch.models.mamba import SCAN_CHUNK
    from repro_torch.models.shardctx import ShardCtx
    if cfg.family != "ssm":
        return 0
    B = len(range(batch)[ShardCtx(D, 1).batch_slice(batch)])
    Di = cfg.d_inner // M
    chunk = B * min(SCAN_CHUNK, seq) * Di * cfg.ssm_state * 4
    starts = scan_start_bytes(cfg, ShapeConfig("t", seq, B, "train")) // M
    return starts + SCAN_BWD_CHUNK_TENSORS * chunk


def mesh_train_bytes(cfg, D: int, M: int, bytes_per_param: float,
                     batch: int = 0, seq: int = 0) -> list:
    """A train step's peak bytes on each card of a (D, M) training mesh,
    reckoned at ``bytes_per_param`` (a measured step's peak over its
    parameters) times the rank's parameters, plus, where the step's
    ``batch`` and ``seq`` are given, the rank's scan bytes
    (:func:`mesh_scan_bytes`)."""
    scan = mesh_scan_bytes(cfg, D, M, batch, seq) if batch else 0
    return [n * bytes_per_param + scan
            for n in mesh_param_counts(cfg, D, M)]


def mesh_train_depth(cfg, D: int, M: int, limit_bytes: float,
                     bytes_per_param: float, batch: int = 0,
                     seq: int = 0) -> int:
    """The most layers (in steps of the config's layer group) at which
    every card's :func:`mesh_train_bytes` stays within ``limit_bytes``
    (0: not even one group)."""
    group = 2 if cfg.layer_pattern == "local_global" else 1
    best = 0
    for n in range(group, cfg.n_layers + 1, group):
        c = dataclasses.replace(cfg, n_layers=n)
        if max(mesh_train_bytes(c, D, M, bytes_per_param, batch,
                                seq)) > limit_bytes:
            break
        best = n
    return best


def _alloc() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _peak_from(start: int):
    """Reset the peak statistic; returns a reader of the peak above
    ``start``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def read() -> int:
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - start
    return read


def state_bytes(state) -> int:
    """Bytes of every tensor of a train state (each storage once)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            key = (x.untyped_storage().data_ptr(), x.device)
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(state)
    return total


def _saved_bytes(fn, exclude=()):
    """``fn()`` under a saved-tensors hook: (its result, the bytes of the
    storages it saves for the backward, each once, less ``exclude``'s)."""
    seen = {t.untyped_storage().data_ptr() for t in exclude}
    total = 0

    def pack(t):
        nonlocal total
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total


def scan_memory(cfg, batch: int, seq: int, device="cuda") -> dict:
    """The recurrent scan's own memory in a train step of ``cfg`` (one
    layer's scan at the step's shapes, from seeded inputs, alone on the
    card): ``saved``, the bytes its forward keeps for the backward;
    ``backward_peak``, its backward's peak allocation above the
    allocation just before it; ``chunk_tensor``, one (B, Q, Di, N) f32
    chunk tensor's bytes for mamba's ``SelectiveScan`` (one (B, Q, Dr)
    for the hybrid's RG-LRU, which autograd runs through); and
    ``layer_saved``, the bytes one whole layer at full width keeps for its
    backward (a one-layer model, no remat: what remat recomputes per
    layer), beside which the scan's are read."""
    from repro_torch import tree as T
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.mamba import SCAN_CHUNK, SelectiveScan
    from repro_torch.models.registry import build_model
    from repro_torch.models.rglru import rglru_scan

    g = torch.Generator(device=device).manual_seed(0)
    B, S, Q = batch, seq, min(SCAN_CHUNK, seq)
    dt_ = getattr(torch, cfg.dtype)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    if cfg.family == "ssm":
        Di, N = cfg.d_inner, cfg.ssm_state
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=device).expand(Di, N).contiguous()
        ins = [rand(B, S, Di, dtype=dt_),
               torch.nn.functional.softplus(rand(B, S, Di) - 4).to(dt_),
               A, rand(B, S, N, dtype=dt_), rand(B, S, N, dtype=dt_)]
        for t in ins:
            t.requires_grad_(True)
        ins.append(torch.zeros((B, Di, N), device=device))
        scan, chunk = SelectiveScan.apply, B * Q * Di * N * 4
    else:
        Dr = cfg.lru_width
        ins = [rand(B, S, Dr).requires_grad_(True),
               torch.sigmoid(rand(B, S, Dr)).requires_grad_(True),
               torch.zeros((B, Dr), device=device)]
        scan, chunk = rglru_scan, B * Q * Dr * 4
    (y, hT), saved = _saved_bytes(lambda: scan(*ins))
    dy = rand(*y.shape)
    peak = _peak_from(_alloc())
    grads = torch.autograd.grad(y, [t for t in ins if t.requires_grad], dy)
    out = {"saved": saved, "backward_peak": peak(), "chunk_tensor": chunk}
    del y, hT, dy, grads, ins

    one = dataclasses.replace(cfg, n_layers=1)
    run = RunConfig(model=one, shape=ShapeConfig("t", S, B, "train"),
                    remat="none")
    model = build_model(one, run, device=device)
    with torch.no_grad():
        model.init_params(g)
    tokens = next(TokenPipeline(model, run.shape, seed=0))
    loss, out["layer_saved"] = _saved_bytes(
        lambda: model.loss(tokens), exclude=T.leaves(model.param_tree()))
    del loss, model
    torch.cuda.empty_cache()
    return out


def step_memory(trainer, state, batch, all_rungs_plan, plan) -> dict:
    """Bytes by owner of one train step of ``trainer`` from ``state``
    (which the step kinds advance).  ``plan`` is the loop's plan,
    ``all_rungs_plan`` one with a group on every rung."""
    from repro_torch import tree as T
    from repro_torch.optim import adamw

    run = trainer.run
    params = state["params"]
    n = sum(p.numel() for p in T.leaves(params))
    out = {"n_params": n, "state": state_bytes(state)}
    base = _alloc()
    out["allocated_at_start"] = base

    leaves, treedef = T.flatten(params)
    peak = _peak_from(base)
    with torch.enable_grad():
        loss = trainer.model.loss(batch)
    out["activations"] = _alloc() - base
    out["forward_peak"] = peak()
    peak = _peak_from(base)
    grads = torch.autograd.grad(loss, leaves)
    del loss
    reduce = None
    if trainer.ctx is not None:
        grads = trainer.model.reduce_grads(grads)
        reduce = trainer._mesh_sum
    out["gradients"] = _alloc() - base
    out["backward_peak"] = peak()
    held = base + out["gradients"]
    grads = T.unflatten(treedef, list(grads))
    peak = _peak_from(held)
    with torch.no_grad():
        grads, _ = adamw.clip_by_global_norm(grads, run.grad_clip, reduce)
        out["clip_peak"] = peak()
        peak = _peak_from(held)
        new = trainer._optimize(params, grads, state["m"], state["v"],
                                state["step"])
        out["adamw_held"] = _alloc() - held
        out["adamw_peak"] = peak()
    del grads, new

    kinds = {}
    for kind, p in (("local", plan), ("delta_sync", plan),
                    ("grad_sync", plan),
                    ("grad_sync_all_rungs", all_rungs_plan)):
        start = _alloc()
        peak = _peak_from(start)
        state, _ = trainer.step(state, batch, p,
                                kind.replace("_all_rungs", ""))
        kinds[kind] = {"peak_above_start": peak(),
                       "peak": peak() + start}
    out["kinds"] = kinds
    out["peak"] = max(k["peak"] for k in kinds.values())
    out["per_param"] = {k: v / n for k, v in out.items()
                        if isinstance(v, int) and k != "n_params"}
    out["per_param"].update({f"{k}_peak": v["peak"] / n
                             for k, v in kinds.items()})
    return out


def main(argv=None):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-350m")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the published one)")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("memory: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    scan = (scan_memory(cfg, args.batch, args.seq_len)
            if cfg.family in ("ssm", "hybrid") else None)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "session", args.seq_len, args.batch, "train"),
            total_steps=100, warmup_steps=2, ckpt_dir=ckpt_dir,
            ckpt_every=0, acesync=ACESyncConfig(replan_every=4))
        sess = TrainSession(build_model(cfg, run, device="cuda"), run,
                            strategy="acesync")
        sess.init()
    tr = sess.trainer
    batch = next(sess.pipeline)
    rr = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.sizes))], (1.0,))
    # the state is handed over, as TrainSession.run hands it to the loop:
    # each step kind frees the state it replaces
    res = step_memory(tr, sess.take_state(), batch, rr, tr.default_plan())
    res.update(arch=args.arch, n_layers=cfg.n_layers,
               tokens=args.seq_len * args.batch,
               device=torch.cuda.get_device_name(0),
               total_bytes=torch.cuda.get_device_properties(0).total_memory,
               reserved_at_end=torch.cuda.memory_reserved())
    if scan:
        res["scan"] = scan
        res["per_param"].update({f"scan_{k}": v / res["n_params"]
                                 for k, v in scan.items()})
    text = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
