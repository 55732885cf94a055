"""Where a train step's time goes on the card: each step kind of the
paper-350m main path under ``torch.profiler``, device time summed by
kernel category, beside the step's wall time on CUDA events; with
``--serve ARCH``, where serving's time goes instead: one prefill of
``--batch`` x ``--seq-len`` tokens and the decode steps after it, the
model at full width from seeded bf16 weights (``serve.init_model``).

    python -m repro_torch.launch.profile [--seq-len 1024] [--batch 8]
        [--repeats 3] [--out build/profile.json]
    python -m repro_torch.launch.profile --serve falcon-mamba-7b \
        --seq-len 512 --batch 4

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
    return {
        "wall_ms": wall, "walls_ms": walls, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall) if wall else None,
        "by_category_ms": dict(sorted(by_cat.items(),
                                      key=lambda kv: -kv[1])),
        "top_kernels_ms": top}


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def profile_serving(arch, batch, seq_len, repeats):
    """One prefill of ``batch`` random prompts of ``seq_len`` tokens and
    the ``repeats`` decode steps after it (each profiled call after one
    unprofiled warm-up), ``arch`` at its published width and depth from
    seeded bf16 weights."""
    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import init_model

    cfg = ARCHS[arch]
    model = init_model(cfg, "cuda", seed=0)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(batch, seq_len)).astype(np.int32)).cuda()
    cache_len = seq_len + 2 * repeats + 2
    with torch.inference_mode():
        model.prefill(toks, cache_len)
        prefill = profile_calls(lambda: model.prefill(toks, cache_len),
                                repeats)
        _, caches = model.prefill(toks, cache_len)
        nxt = toks[:, -1:]
        pos = [seq_len]

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
    from repro_torch.configs.base import ACESyncConfig
    from repro_torch.launch.session import TrainSession

    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
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
    out = {"device": torch.cuda.get_device_name(0), "card": card_name(),
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
    write(out, args.out)


def write(out: dict, path: str) -> None:
    text = json.dumps(out, indent=1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
