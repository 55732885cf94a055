#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right and trains.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result lines):

1. card check: a CUDA device, and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each gather + EF encode kernel (K1-K4) against its plain PyTorch
   version on the card, bit for bit: the reference's ``_gather_case``
   inputs (a denormal row, an all-zero row, the zero pad row, perm lengths
   1-23, gamma 1.0 / 0.9 / 0.6) and a perm over every block of
   paper-350m (NB = 443,697 rows of 1024 f32), the top-k kernel at every
   k the ladder's top-k rungs use; time kernel and plain version on that
   perm with CUDA events;
4. agreement on a small input: one smoke-model ``grad_sync`` step on the
   card (kernels) and on the CPU (plain versions) from the same weights;
5. the main path: paper-350m at full width (24 layers, d 1024, vocab
   50,304, seq 1024, batch 8) under ``acesync`` with ``replan_every=4``
   through ``TrainSession`` for 8 steps (two ``delta_sync`` rounds, one
   device replan), then one ``grad_sync`` step under a plan that puts the
   11 parameter groups round-robin on all 8 ladder rungs.  Every kernel's
   launch count is reset just before and read just after; each must have
   launched, and every loss must be finite.

Output: progress lines, then the ``nvidia-smi`` line, the kernels' JSON
line, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

NB_350M = 443_697                   # blocks of paper-350m's 11 groups
HBM_BYTES_PER_S = 3.35e12           # H100 SXM datasheet
FP32_FLOPS = 67e12                  # H100 SXM datasheet, non-tensor f32
LANES = 1024
SOURCE = "src/repro_torch/kernels/csrc/gather_encode.cu"
#: name -> (TPU kernel it replaces, bytes written per row, f32 operations
#: per element of the row body).  int8 / int4 / sign write the encoded row,
#: its scale, the residual and own = ef - residual; top-k writes the
#: selection and the residual.
KERNELS = {
    "gather_ef_int8": ("src/repro/kernels/quantize.py:68", 9220, 10),
    "gather_ef_int4": ("src/repro/kernels/quantize.py:151", 8708, 11),
    "gather_ef_sign": ("src/repro/kernels/sign.py:72", 9220, 8),
    "gather_ef_topk": ("src/repro/kernels/topk_compress.py:159", 8192, 38),
}
#: k of the 25 / 10 / 1 % top-k rungs (the all-rungs step runs all three);
#: the timed call uses the 10 % rung's
TOPK_KS = (256, 104, 16)
TOPK_K = 104


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _fns(ops, ref, name, k=TOPK_K):
    """(kernel wrapper, plain version) of ``name`` as f(fb, eb, perm, g);
    ``k`` is the top-k kernel's."""
    if name == "gather_ef_topk":
        return (lambda f, e, p, g: ops.gather_ef_topk(f, e, p, gamma=g, k=k),
                lambda f, e, p, g: ref.ef_topk_gather_ref(f, e, p, gamma=g,
                                                          k=k))
    plain = {"gather_ef_int8": ref.quantize_int8_gather_ref,
             "gather_ef_int4": ref.ef_int4_gather_ref,
             "gather_ef_sign": ref.ef_sign_gather_ref}[name]
    kern = getattr(ops, name)
    return (lambda f, e, p, g: kern(f, e, p, gamma=g),
            lambda f, e, p, g: plain(f, e, p, gamma=g))


def compare(torch, got, want) -> float:
    """Bit-compare kernel and plain outputs; returns max |difference|
    (raises through ``fail`` when any bit differs)."""
    err = 0.0
    for a, b in zip(got, want):
        b = b.reshape(a.shape)
        if a.dtype != b.dtype:
            fail(f"dtype {a.dtype} != {b.dtype}")
        same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
                if a.dtype == torch.float32 else torch.equal(a, b))
        d = (a.float() - b.float()).abs()
        d = float(d.max()) if d.numel() else 0.0
        err = max(err, d if math.isfinite(d) else float("inf"))
        if not same:
            fail(f"kernel and plain version differ (max abs {d})")
    return err


def gather_cases(np, torch, dev):
    """The reference's _gather_case inputs: perm lengths 1-23, denormal /
    all-zero / zero-pad rows."""
    out = []
    for S in range(1, 24):
        nbp1 = 2 + (S * 5) % 9
        r = np.random.RandomState(S)
        fb = r.randn(nbp1, LANES).astype(np.float32)
        eb = r.randn(nbp1, LANES).astype(np.float32)
        if S % 2 and nbp1 > 3:
            fb[0] *= 1e-41
            eb[0] *= 1e-41
            fb[1] = 0.0
            eb[1] = 0.0
        fb[-1] = 0.0
        eb[-1] = 0.0
        perm = r.randint(0, nbp1, size=S).astype(np.int32)
        out.append(tuple(torch.from_numpy(x).to(dev) for x in (fb, eb,
                                                                perm)))
    return out


def time_ms(torch, fn, iters: int) -> float:
    fn()                                            # warm up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def ks(name):
    """The k values phase 3 checks ``name`` at (only top-k reads k)."""
    return TOPK_KS if name == "gather_ef_topk" else (TOPK_K,)


def kernel_phase(np, torch, ops, ref, dev) -> dict:
    """Phase 3: bit parity on the gather cases and on the full-model perm;
    kernel and plain-version times on the full-model perm."""
    results = {}
    cases = gather_cases(np, torch, dev)
    for name in KERNELS:
        err = 0.0
        for k in ks(name):
            kern, plain = _fns(ops, ref, name, k)
            for fb, eb, perm in cases:
                for gamma in (1.0, 0.9, 0.6):
                    err = max(err, compare(torch, kern(fb, eb, perm, gamma),
                                           plain(fb, eb, perm, gamma)))
        results[name] = {"max_abs_err": err}
    log(f"phase 3: K1-K4 bit-exact on {len(cases)} gather cases x 3 gammas "
        f"(top-k at k = {TOPK_KS})")

    g = torch.Generator(device=dev).manual_seed(0)
    fb = torch.randn((NB_350M + 1, LANES), generator=g, device=dev)
    eb = torch.randn((NB_350M + 1, LANES), generator=g, device=dev)
    fb[0] *= 1e-41
    eb[0] *= 1e-41
    fb[1] = 0.0
    eb[1] = 0.0
    fb[-1] = 0.0
    eb[-1] = 0.0
    # the perm a plan putting every group on one rung builds: all NB rows
    perm = torch.arange(NB_350M, dtype=torch.int32, device=dev)
    S = NB_350M
    for name, (_, wbytes, flops_el) in KERNELS.items():
        err = 0.0
        for k in ks(name):
            kern, plain = _fns(ops, ref, name, k)
            err = max(err, compare(torch, kern(fb, eb, perm, 0.9),
                                   plain(fb, eb, perm, 0.9)))
            torch.cuda.empty_cache()
        kern, plain = _fns(ops, ref, name)
        ms = time_ms(torch, lambda: kern(fb, eb, perm, 0.9), 10)
        plain_ms = time_ms(torch, lambda: plain(fb, eb, perm, 0.9), 2)
        torch.cuda.empty_cache()
        nbytes = S * (2 * LANES * 4 + 4 + wbytes)
        nops = S * LANES * flops_el
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_FLOPS * 1e3
        r = results[name]
        r.update(max_abs_err=max(r["max_abs_err"], err), ms=ms,
                 plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 bytes=nbytes, gbps=nbytes / (ms * 1e-3) / 1e9)
        log(f"phase 3: {name} full-model perm (S={S}) bit-exact; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"{nbytes / 1e9:.3f} GB moved, {r['gbps']:.0f} GB/s of "
            f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s datasheet, "
            f"bound {r['bound_ms']:.3f} ms")
    del fb, eb, perm
    torch.cuda.empty_cache()
    return results


def small_agreement(torch):
    """Phase 4: one smoke-model grad_sync step on the card and on the CPU
    from the same state and batch; the losses and updated weights must
    agree (the CPU runs the plain versions, the card the kernels)."""
    from repro_torch import convert
    from repro_torch import tree as T
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import build_model

    run = RunConfig(model=SMOKE_ARCHS["paper-350m"],
                    shape=ShapeConfig("s", 64, 2, "train"), lr=1e-2,
                    warmup_steps=1)
    card = Trainer(build_model(run.model, run, device="cuda"), run)
    host = Trainer(build_model(run.model, run, device="cpu"), run)
    states = [card.init_state(0)]
    states.append(convert.move_state(states[0], host))
    outs = []
    for tr, state in zip((card, host), states):
        batch = next(TokenPipeline(tr.model, run.shape, seed=1))
        plan = tr.scheduler.plan_from_levels(
            [i % 8 for i in range(len(tr.sizes))], (1.0,))
        state, m = tr.step(state, batch, plan, "grad_sync")
        outs.append((float(m["loss"]),
                     [p.detach().cpu() for p in T.leaves(state["params"])]))
    (lc, pc), (lh, ph) = outs
    if not (math.isfinite(lc) and abs(lc - lh) <= 2e-2 * abs(lh)):
        fail(f"small-input loss: card {lc} vs cpu {lh}")
    worst = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    if worst > 1e-3:
        fail(f"small-input updated weights differ by {worst}")
    log(f"phase 4: smoke grad_sync step card loss {lc:.6f} vs cpu "
        f"{lh:.6f}; max weight difference {worst:.3g}")


def main_path(torch, ops) -> dict:
    """Phase 5: paper-350m at full width through TrainSession, then one
    all-rungs grad_sync step."""
    from repro_torch import tree as T
    from repro_torch.configs.base import ACESyncConfig
    from repro_torch.launch.session import TrainSession

    sess = TrainSession.from_config(
        "paper-350m", strategy="acesync", smoke=False, seq_len=1024,
        batch=8, steps=100, device="cuda", warmup_steps=2,
        acesync=ACESyncConfig(replan_every=4))
    cfg = sess.model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 1024, 50304)
    trainer = sess.trainer
    times = []
    step = trainer.step

    def timed(state, batch, plan, kind="grad_sync"):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(state, batch, plan, kind)
        e1.record()
        times.append((kind, e0, e1))
        return out

    trainer.step = timed
    sess.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(8, log_every=1)
    plan = trainer.scheduler.plan_from_levels(
        [i % 8 for i in range(len(trainer.sizes))], (1.0,))
    rungs = sorted(set(plan.level_idx))
    state, metrics = trainer.step(sess.state, next(sess.pipeline), plan,
                                  "grad_sync")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gs_loss = float(metrics["loss"])

    losses = sess.losses + [gs_loss]
    kinds = [k for h in sess.history for k in h["kinds"]]
    if rungs != list(range(8)):
        fail(f"round-robin plan covers rungs {rungs}")
    if kinds.count("delta_sync") < 2:
        fail(f"only {kinds.count('delta_sync')} delta_sync rounds")
    if sess.loop.device_replans < 1:
        fail("no device replan was applied")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not 5.0 < losses[0] < 20.0:
        fail(f"implausible initial loss {losses[0]} (ln V = "
             f"{math.log(cfg.vocab_size):.2f})")
    if not all(bool(torch.isfinite(p).all())
               for p in T.leaves(state["params"])):
        fail("non-finite parameters after the main path")
    missing = [k for k, n in launches.items() if n < 1]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    per_kind: dict = {}
    for kind, e0, e1 in times:
        per_kind.setdefault(kind, []).append(e0.elapsed_time(e1))
    tokens = 8 * 1024
    for kind, ms in per_kind.items():
        # the first step of a kind carries one-time set-up (cuBLAS
        # handles, allocator growth): steady = the later steps' mean
        steady = ms[1:] or ms
        mean = sum(steady) / len(steady)
        extra = (f", {tokens / (mean / 1e3):.0f} tokens/s"
                 if kind in ("local", "grad_sync") else "")
        log(f"phase 5: {kind}: {len(ms)} steps, ms "
            f"{[round(x, 2) for x in ms]}; steady mean {mean:.2f} ms"
            f"{extra}")
    log(f"phase 5: losses {[round(x, 4) for x in losses]}; "
        f"{kinds.count('delta_sync')} delta_sync rounds, "
        f"{sess.loop.device_replans} device replan(s), plan levels after "
        f"replan {list(sess.loop.plan.level_idx)}")
    log(f"phase 5: launches {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB; wall {wall:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not next to this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    log(f"phase 1: {torch.cuda.get_device_name(0)} (torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")

    from repro_torch.kernels import build, ops, ref
    t0 = time.perf_counter()
    build.load()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.last_build.get('seconds', 0.0):.2f} s) -> "
        f"{build.last_build.get('path')}")

    results = kernel_phase(np, torch, ops, ref, dev)
    small_agreement(torch)
    launches = main_path(torch, ops)

    kernels = []
    for name, (replaces, _, _) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "parity": "bit-exact", "bytes": r["bytes"],
            "gbps": r["gbps"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
