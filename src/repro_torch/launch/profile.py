"""Where a train step's time goes on the card: each step kind of the
paper-350m main path under ``torch.profiler``, device time summed by
kernel category, beside the step's wall time on CUDA events.

    python -m repro_torch.launch.profile [--seq-len 1024] [--batch 8]
        [--repeats 3] [--out build/profile.json]

Needs a CUDA device.  The session first runs 8 warm-up steps through
``TrainSession`` (two ``delta_sync`` rounds and a device replan, as in
``chip_smoke.py``); then each step kind runs ``--repeats`` times under the
profiler, with the acesync plan the loop is using and, for ``grad_sync``,
also with a plan spreading the groups over all 8 ladder rungs.  Prints one
JSON object (and writes it to ``--out``): per step kind, the mean wall
time, the device-busy time and idle share, the device time per category,
and the top kernels.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

#: kernel-name fragments -> category (first match wins)
CATEGORIES = (
    ("gather_ef", "gather+EF encode (port kernels)"),
    ("flash", "attention"), ("fmha", "attention"), ("attention", "attention"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("nvjet", "matmul"),
    ("sm90_xmma", "matmul"), ("cublas", "matmul"),
    ("sort", "sort (top-k wire)"), ("radix", "sort (top-k wire)"),
    ("index", "gather/scatter"), ("scatter", "gather/scatter"),
    ("gather", "gather/scatter"),
    ("reduce", "reductions"), ("Memcpy", "memcpy/memset"),
    ("Memset", "memcpy/memset"),
)


def category(name: str) -> str:
    for frag, cat in CATEGORIES:
        if frag in name:
            return cat
    return "elementwise/other"


def profile_kind(trainer, state, batch, plan, kind, repeats):
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, _ = trainer.step(state, batch, plan, kind)
            e1.record()
            torch.cuda.synchronize()
            walls.append(e0.elapsed_time(e1))
    by_cat = defaultdict(float)
    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            by_cat[category(ev.key)] += dev_us / 1e3 / repeats
            by_kernel[ev.key] += dev_us / 1e3 / repeats
    busy = sum(by_cat.values())
    wall = sum(walls) / len(walls)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return state, {
        "wall_ms": wall, "walls_ms": walls, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall) if wall else None,
        "by_category_ms": dict(sorted(by_cat.items(),
                                      key=lambda kv: -kv[1])),
        "top_kernels_ms": top}


def main(argv=None):
    from repro_torch.configs.base import ACESyncConfig
    from repro_torch.launch.session import TrainSession

    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="build/profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")

    # a fresh state every time: no checkpoint is resumed or written
    with tempfile.TemporaryDirectory() as ckpt_dir:
        sess = TrainSession.from_config(
            "paper-350m", smoke=False, seq_len=args.seq_len,
            batch=args.batch, steps=100, device="cuda", warmup_steps=2,
            acesync=ACESyncConfig(replan_every=4), ckpt_dir=ckpt_dir,
            ckpt_every=0)
        sess.run(8, log_every=0)
    tr = sess.trainer
    batch = next(sess.pipeline)
    rr = tr.scheduler.plan_from_levels(
        [i % 8 for i in range(len(tr.sizes))], (1.0,))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "card": card,
           "tokens_per_step": args.seq_len * args.batch,
           "acesync_plan": list(sess.loop.plan.level_idx), "kinds": {}}
    state = sess.state
    for kind, plan in (("local", sess.loop.plan),
                       ("delta_sync", sess.loop.plan),
                       ("grad_sync", sess.loop.plan),
                       ("grad_sync_all_rungs", rr)):
        state, rec = profile_kind(tr, state, batch, plan,
                                  kind.replace("_all_rungs", ""),
                                  args.repeats)
        out["kinds"][kind] = rec
    text = json.dumps(out, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
