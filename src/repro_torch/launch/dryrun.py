"""Dry run: every (arch x shape) cell of the reference's production meshes
counted for one rank of the port, on the meta device — port of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 512 fake XLA devices and
reads memory, FLOPs and collective bytes off the compiled program.  The
port runs one process per rank and has no compiled program, so a dry run
builds one rank of the production layout (``launch.mesh.
production_layout``: (16, 16) ("data", "model"), or (2, 16, 16) ("pod",
"data", "model") with ``--multi-pod``) on the meta device — its model,
and for a train cell its ``Trainer`` and train state — with dry process
groups (``launch/dry.py``), and runs the cell's step once under the
counters of ``analysis/cost.py``:

  * train cells: ``default_plan(bandwidth_mbps=50.0)`` and one step of
    the strategy's ``representative_kind`` on the pod's rows of the
    global batch (every rank of a pod takes them and keeps its "data"
    block, as a real rank does);
  * serve cells: bf16 parameters, then ``prefill`` on the pod's rows, or
    one ``decode_step`` at the cache's last position on ``init_cache``'s
    caches (written in place, as the reference donates them).

The step is traced on rank (0, 0) of pod 0.  Every rank's state bytes
(serving: its bf16 parameters) are reckoned from the layout's specs, and
``bytes_per_device`` is the largest rank's: the traced rank's counted
peak with its state replaced by the largest rank's.  Nothing runs on a
card and nothing is built: the kernel wrappers record the launches they
would make.  No time or rate is reckoned here — a roofline is the
benchmark's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod] [--strategy acesync] [--out build/dryrun]
        [--remat R] [--q-chunk N] [--kv-chunk N]

writes one JSON record per cell, ``<mesh>_<arch>_<shape>_<strategy>.json``,
and prints the reference's two lines per cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import tree as T
from repro_torch.analysis.cost import Counters, tensor_bytes
from repro_torch.configs import ARCHS, SHAPES, cells
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import planexec
from repro_torch.core.trainer import Trainer, param_path
from repro_torch.launch.dry import META, dry_layout
from repro_torch.launch.mesh import production_layout
from repro_torch.models.flops import model_flops
from repro_torch.models.registry import build_model
from repro_torch.models.shardctx import ShardCtx
from repro_torch.strategies import list_strategies

#: the card the counts are held against: one H100's memory
CARD_BYTES = 80e9
OUT = os.path.join("build", "dryrun")


def _meta_inputs(specs: dict) -> dict:
    return {k: torch.empty(shape, dtype=dtype, device=META)
            for k, (shape, dtype) in specs.items()}


def _rank_shard_bytes(model, D: int, M: int, leaves) -> list:
    """Per mesh rank d * M + m: the bytes of ``leaves`` ((parameter path
    or None, whole shape, element size)) as that rank holds them — a
    parameter's leaf as the parameter's shard, any other whole."""
    out = []
    for r in range(D * M):
        at = ShardCtx(D, M, r // M, r % M)
        total = 0
        for path, shape, size in leaves:
            if path is not None:
                shape = at.local_shape(model._specs[path],
                                       model.full_shapes[path])
            total += math.prod(shape) * size
        out.append(total)
    return out


def state_leaves(state) -> list:
    """(parameter path or None, whole shape, element size) of each leaf
    of a train state: the parameter-shaped trees follow their
    parameter's shard (``Trainer.state_layout``'s rule)."""
    out = []
    for path, leaf in T.reference_leaves_with_path(state):
        p = param_path(T.path_str(path))
        out.append((p, tuple(leaf.shape), leaf.element_size()))
    return out


def param_leaves(model, dtype_bytes: int) -> list:
    return [(T.path_str(q), None, dtype_bytes)
            for q, _ in T.leaves_with_path(model.param_tree())]


def pod_priced_bytes(ep, n_pods: int) -> int:
    """The bytes an exec plan's exchange moves into one pod, priced on its
    executed signatures (``planexec.sig_wire_bytes``, one per backward
    segment): what the pod tier's log must hold (FULL's within its shard
    padding where P does not divide a piece)."""
    grids = ep.seg_sig if ep.segmented else (ep.sig,)
    return sum(planexec.sig_wire_bytes(sig, ep.levels, n_pods, ep.block)
               for sig in grids)


def dry_step(cfg: ModelConfig, shape: ShapeConfig, *, P: int = 1,
             D: int = 1, M: int = 1, strategy: str = "acesync",
             run: Optional[RunConfig] = None, plan=None, kind=None,
             trace: bool = True) -> dict:
    """One rank (pod 0, (0, 0)) of P pods of D x M meshes, dry: its model
    (train: and Trainer and state) on the meta device, and with
    ``trace`` its step counted.  ``run`` defaults to the reference's
    ``RunConfig(model=cfg, shape=shape)``; a train step runs ``plan``
    (default ``default_plan(bandwidth_mbps=50.0)``; a callable: its plan
    of the trainer, a host plan or an exec plan) and ``kind`` (default
    the strategy's representative kind).  Returns the record's counts:
    ``plan`` / ``bucket_sig`` (train) or ``mode`` (serve), ``memory``,
    ``state_bytes_per_rank`` and, traced, ``walker`` and ``trace_s``."""
    run = run or RunConfig(model=cfg, shape=shape, multi_pod=P > 1)
    ctx, pods, log = dry_layout(P, D, M)
    t0 = time.perf_counter()
    # one card a pod is no mesh: the model then recomputes a layer in the
    # backward only as far as its saved tensors need, as on the card
    model = build_model(cfg, run, device=META,
                        ctx=ctx if D * M > 1 else None)
    rec: dict = {}
    # a pod takes its rows of the global batch (the reference shards the
    # batch over ("pod", "data")), all of them where P does not divide it
    B = shape.global_batch
    pod_shape = dataclasses.replace(shape, global_batch=B // P
                                    if B % P == 0 else B)
    if shape.kind == "train":
        trainer = Trainer(model, run, strategy=strategy, pods=pods)
        if callable(plan):
            plan = plan(trainer)
        plan = plan or trainer.default_plan(bandwidth_mbps=50.0)
        kind = kind or trainer.strategy.representative_kind
        state = trainer.state_of_params(
            torch.Generator().manual_seed(run.seed))
        if hasattr(plan, "level_idx"):
            rec.update(plan=[plan.levels[i].name for i in plan.level_idx],
                       bucket_sig=list(plan.bucket_sig or ()))
        rec.update(strategy=trainer.strategy_name, kind=kind)
        ranks = _rank_shard_bytes(model, D, M, state_leaves(state))
        inputs = _meta_inputs(model.input_specs(pod_shape))
        ep = trainer.exec_plan(plan)
        if pods is not None:
            rec["pod_priced_bytes"] = pod_priced_bytes(ep, trainer.n_pods)

        def step():
            trainer.step(state, inputs, ep, kind)
    else:
        model = model.to(torch.bfloat16)
        state = model.param_tree()
        ranks = _rank_shard_bytes(model, D, M, param_leaves(model, 2))
        inputs = _meta_inputs(model.input_specs(pod_shape))
        rec["mode"] = shape.kind
        if shape.kind == "prefill":
            def step():
                model.prefill(inputs["tokens"], **{
                    k: inputs[k] for k in model.float_inputs})
        else:
            inputs["caches"] = model.init_cache(pod_shape.global_batch,
                                                shape.cache_len)

            def step():
                model.decode_step(inputs["caches"], shape.cache_len - 1,
                                  inputs["tokens"])
    rec["build_s"] = time.perf_counter() - t0
    state_b, inputs_b = tensor_bytes(state), tensor_bytes(inputs)
    rec["state_bytes_per_rank"] = {"traced": ranks[0], "min": min(ranks),
                                   "max": max(ranks)}
    rec["memory"] = {"state_bytes": state_b, "input_bytes": inputs_b}
    if not trace:
        return rec
    t1 = time.perf_counter()
    with Counters(log) as c:
        step()
    rec["trace_s"] = time.perf_counter() - t1
    rep = c.report
    peak = state_b + inputs_b + rep.transient_peak
    rec["memory"].update(transient_peak_bytes=rep.transient_peak,
                         peak_bytes=peak)
    rec["bytes_per_device"] = peak - ranks[0] + max(ranks)
    rec["walker"] = {
        "flops_per_device": rep.flops,
        "bytes_per_device": rep.bytes_accessed,
        "collective_bytes_per_device": rep.collective_bytes,
        "collective_counts": rep.collective_count,
        "op_flops": rep.op_flops,
        "kernels": rep.kernels,
    }
    return rec


def dry_cell(arch: str, shape_name: str, *, multi_pod: bool,
             strategy: str = "acesync", run_overrides: Optional[dict] = None,
             trace: bool = True, out_dir: Optional[str] = None) -> dict:
    """One cell of the reference's dry run, for rank (0, 0) of pod 0 of
    the production layout: the reference's record keys where they mean
    the same (``arch``, ``shape``, ``mesh``, ``strategy``, ``ok``,
    ``plan``, ``bucket_sig``, ``n_chips``, ``memory``,
    ``bytes_per_device``, ``model_flops_global``, ``useful_ratio``, the
    ``walker`` block of counts per device).  A failure sets ``ok`` false
    with the error.  ``out_dir``: the record is written there."""
    dims, _ = production_layout(multi_pod)
    P, D, M = (1,) * (3 - len(dims)) + tuple(dims)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(n) for n in dims), "strategy": strategy,
           "ok": False}
    try:
        cfg, shape = ARCHS[arch], SHAPES[shape_name]
        run = RunConfig(model=cfg, shape=shape, multi_pod=multi_pod,
                        **(run_overrides or {}))
        rec.update(dry_step(cfg, shape, P=P, D=D, M=M, strategy=strategy,
                            run=run, trace=trace))
        n_chips = P * D * M
        mf = model_flops(cfg, shape)
        rec.update(ok=True, n_chips=n_chips, rank=[0, 0, 0],
                   model_flops_global=mf)
        if trace:
            flops = rec["walker"]["flops_per_device"]
            rec.update(flops_global=flops * n_chips,
                       useful_ratio=(mf / (flops * n_chips)
                                     if flops else None),
                       fits=rec["bytes_per_device"] <= CARD_BYTES)
    except Exception as e:  # noqa: BLE001 — recorded, never skipped
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{rec['mesh']}_{arch}_{shape_name}_{strategy}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def report_lines(rec: dict) -> list:
    """The reference's two lines of a cell (``trace`` in place of its
    ``compile``; the second only for an ``ok`` record)."""
    status = "OK" if rec.get("ok") else f"FAIL {rec.get('error')}"
    out = [f"[{rec['mesh']}] {rec['arch']} x {rec['shape']} "
           f"({rec['strategy']}): {status}  trace={rec.get('trace_s')}s"
           f"  mem/dev={rec.get('bytes_per_device', 0) / 1e9:.2f}GB"]
    if rec.get("ok") and "walker" in rec:
        w = rec["walker"]
        cb = w["collective_bytes_per_device"]
        out.append(f"    flops/dev={w['flops_per_device']:.3e}"
                   f"  bytes/dev={w['bytes_per_device']:.3e}"
                   f"  collectives={ {k: f'{v:.2e}' for k, v in cb.items()} }")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="acesync",
                    choices=list_strategies())
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--kv-chunk", type=int, default=None)
    args = ap.parse_args(argv)

    overrides = {}
    if args.remat:
        overrides["remat"] = args.remat
    if args.q_chunk:
        overrides["q_chunk"] = args.q_chunk
    if args.kv_chunk:
        overrides["kv_chunk"] = args.kv_chunk

    if args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        todo = cells()
        if args.arch:
            todo = [(a, s) for a, s in todo if a == args.arch]

    bad = 0
    for arch, shape in todo:
        rec = dry_cell(arch, shape, multi_pod=args.multi_pod,
                       strategy=args.strategy, out_dir=args.out,
                       run_overrides=overrides or None)
        bad += not rec["ok"]
        for line in report_lines(rec):
            print(line, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
