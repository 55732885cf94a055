"""Where a train step's time goes on the card: each step kind of one
pod's train path (paper-350m by default; ``--arch`` at full width, cut
to ``--layers``) under ``torch.profiler``, device time summed by kernel
category, beside the step's wall time on CUDA events; with ``--serve
ARCH``, where serving's time goes instead: one prefill of ``--batch`` x
``--seq-len`` tokens and the decode steps after it, the model at full
width from seeded bf16 weights (``serve.init_model``).

    python -m repro_torch.launch.profile [--seq-len 1024] [--batch 8]
        [--repeats 3] [--out build/profile.json]
    python -m repro_torch.launch.profile --arch falcon-mamba-7b \
        --layers 12 --kinds local delta_sync
    python -m repro_torch.launch.profile --serve falcon-mamba-7b \
        --seq-len 512 --batch 4

Needs a CUDA device.  The session first runs 8 warm-up steps through
``TrainSession`` under ``acesync`` with ``replan_every=4`` (two
``delta_sync`` rounds and a device replan, as in ``chip_smoke.py``);
then each step kind of ``--kinds`` (default: all four) runs
``--repeats`` times under the profiler, with the acesync plan the loop
is using and, for ``grad_sync_all_rungs``, a plan spreading the groups
over all 8 ladder rungs.  Prints one JSON
object (and writes it to ``--out``): per step kind, the mean wall time,
the device-busy time and idle share, the device time per category, the
top kernels, and the device time under mamba's selective-scan ranges
(``models/mamba.py`` ``SCAN_RANGES``; their kernels are also in the
categories).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

#: kernel-name fragments -> category (first match wins); the port's own
#: kernels are named in ``kernels/csrc``
CATEGORIES = (
    ("encode_kernel", "encode (port kernels K1-K4, K12-K15)"),
    ("decode_kernel", "fold (port kernels K5-K11)"),
    ("dequant_int8_kernel", "dequantise (port kernel K16)"),
    ("flash", "attention"), ("fmha", "attention"), ("attention", "attention"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("nvjet", "matmul"),
    ("sm90_xmma", "matmul"), ("cublas", "matmul"),
    ("sort", "sort (top-k wire)"), ("radix", "sort (top-k wire)"),
    ("index", "gather/scatter"), ("scatter", "gather/scatter"),
    ("gather", "gather/scatter"),
    ("reduce", "reductions"), ("Memcpy", "memcpy/memset"),
    ("Memset", "memcpy/memset"),
)


#: the step kinds profiled by default, in order (``grad_sync_all_rungs``:
#: ``grad_sync`` under a plan with a group on every rung)
KINDS = ("local", "delta_sync", "grad_sync", "grad_sync_all_rungs")


def category(name: str) -> str:
    for frag, cat in CATEGORIES:
        if frag in name:
            return cat
    return "elementwise/other"


def profile_kind(trainer, state, batch, plan, kind, repeats):
    box = [state]

    def step():
        box[0], _ = trainer.step(box[0], batch, plan, kind)

    rec = profile_calls(step, repeats)
    return box[0], rec


def profile_calls(fn, repeats):
    """``fn()`` ``repeats`` times under the profiler: the mean wall time
    (CUDA events), device-busy time and idle share, device time per
    category and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            walls.append(e0.elapsed_time(e1))
    from repro_torch.models.mamba import SCAN_RANGES

    by_cat = defaultdict(float)
    by_kernel = defaultdict(float)
    scan = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if ev.key in SCAN_RANGES and dev_us:
            # a range is listed as a host op and as a device annotation
            scan[ev.key] = max(scan.get(ev.key, 0.0),
                               dev_us / 1e3 / repeats)
        elif ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            by_cat[category(ev.key)] += dev_us / 1e3 / repeats
            by_kernel[ev.key] += dev_us / 1e3 / repeats
    busy = sum(by_cat.values())
    wall = sum(walls) / len(walls)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms": wall, "walls_ms": walls, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall) if wall else None,
        "by_category_ms": dict(sorted(by_cat.items(),
                                      key=lambda kv: -kv[1])),
        "top_kernels_ms": top, "scan_ranges_ms": scan}


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def profile_serving(arch, batch, seq_len, repeats):
    """One prefill of ``batch`` random prompts of ``seq_len`` tokens (and
    a frontend stub's seeded float inputs) and the ``repeats`` decode
    steps after it (each profiled call after one unprofiled warm-up),
    ``arch`` at its published width and depth from seeded bf16
    weights."""
    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import init_model

    cfg = ARCHS[arch]
    model = init_model(cfg, "cuda", seed=0)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(batch, seq_len)).astype(np.int32)).cuda()
    # a frontend stub's float inputs, seeded and non-zero (zero frames
    # would make the encoder's output exactly 0)
    g = torch.Generator("cuda").manual_seed(0)
    inputs = {k: torch.randn(d, generator=g, device="cuda") * 0.02
              for k, d in model.frontend_shapes(batch, seq_len).items()}
    cache_len = model.n_prefix + seq_len + 2 * repeats + 2
    with torch.inference_mode():
        model.prefill(toks, cache_len, **inputs)
        prefill = profile_calls(
            lambda: model.prefill(toks, cache_len, **inputs), repeats)
        _, caches = model.prefill(toks, cache_len, **inputs)
        nxt = toks[:, -1:]
        pos = [model.n_prefix + seq_len]

        def step():
            model.decode_step(caches, pos[0], nxt)
            pos[0] += 1

        step()
        decode = profile_calls(step, repeats)
    return {"device": torch.cuda.get_device_name(0), "card": card_name(),
            "arch": arch, "layers": cfg.n_layers, "batch": batch,
            "seq_len": seq_len,
            "kinds": {"prefill": prefill, "decode_step": decode}}


def main(argv=None):
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import (ACESyncConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.launch.session import TrainSession
    from repro_torch.models.registry import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-350m",
                    help="the trained arch, at full width")
    ap.add_argument("--layers", type=int, default=None,
                    help="its depth (default: the published one)")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kinds", nargs="+", default=list(KINDS),
                    choices=KINDS, help="the step kinds profiled")
    ap.add_argument("--out", default="build/profile.json")
    ap.add_argument("--serve", metavar="ARCH", default=None,
                    help="profile serving ARCH instead of training")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    if args.serve:
        write(profile_serving(args.serve, args.batch, args.seq_len,
                              args.repeats), args.out)
        return

    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    # a fresh state every time: no checkpoint is resumed or written
    with tempfile.TemporaryDirectory() as ckpt_dir:
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "session", args.seq_len, args.batch, "train"),
            total_steps=100, warmup_steps=2, ckpt_dir=ckpt_dir,
            ckpt_every=0, acesync=ACESyncConfig(replan_every=4))
        sess = TrainSession(build_model(cfg, run, device="cuda"), run,
                            strategy="acesync")
        sess.run(8, log_every=0)
    tr = sess.trainer
    batch = next(sess.pipeline)
    rr = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.sizes))], (1.0,))
    out = {"device": torch.cuda.get_device_name(0), "card": card_name(),
           "arch": args.arch, "layers": cfg.n_layers,
           "tokens_per_step": args.seq_len * args.batch,
           "acesync_plan": list(sess.loop.plan.level_idx), "kinds": {}}
    # handed over: each profiled step frees the state it replaces
    state = sess.take_state()
    plans = {"local": sess.loop.plan, "delta_sync": sess.loop.plan,
             "grad_sync": sess.loop.plan, "grad_sync_all_rungs": rr}
    for kind in args.kinds:
        state, rec = profile_kind(tr, state, batch, plans[kind],
                                  kind.replace("_all_rungs", ""),
                                  args.repeats)
        out["kinds"][kind] = rec
    write(out, args.out)


def write(out: dict, path: str) -> None:
    text = json.dumps(out, indent=1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
