"""The dry-run sweep: every cell in a subprocess of its own (a crash then
costs one cell, not the sweep), resumable — a cell with an ``ok`` record
in the output directory is skipped.  The twin of the reference's
``scripts/sweep.py``, with its todo list: every cell of ``cells()`` on
2 x 16 x 16 and on 16 x 16 under ``acesync``, then every other
registered strategy on paper-350m x train_4k (2 x 16 x 16), the paper's
three baselines on qwen3-8b x train_4k, and paper-350m under ``acesync``
on both meshes.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--out build/dryrun]
        [--timeout 900]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import cells
from repro_torch.launch.dryrun import OUT
from repro_torch.strategies import list_strategies

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def record_path(out: str, mesh: str, arch: str, shape: str,
                strategy: str) -> str:
    return os.path.join(out, f"{mesh}_{arch}_{shape}_{strategy}.json")


def done_ok(path: str) -> bool:
    try:
        with open(path) as f:
            return bool(json.load(f).get("ok", False))
    except (OSError, ValueError):
        return False


def todo_list() -> list:
    """(arch, shape, multi_pod, strategy) in the reference's order."""
    todo = [(a, s, True, "acesync") for a, s in cells()]
    todo += [(a, s, False, "acesync") for a, s in cells()]
    todo += [("paper-350m", "train_4k", True, s) for s in list_strategies()
             if s != "acesync"]
    todo += [("qwen3-8b", "train_4k", True, s)
             for s in ("fullsync", "topk", "fedavg")]
    todo += [("paper-350m", "train_4k", True, "acesync"),
             ("paper-350m", "train_4k", False, "acesync")]
    return todo


def run(arch: str, shape: str, multi_pod: bool, strategy: str, out: str,
        timeout: float) -> bool:
    mesh = "2x16x16" if multi_pod else "16x16"
    path = record_path(out, mesh, arch, shape, strategy)
    if done_ok(path):
        print(f"skip {mesh} {arch} {shape} {strategy} (done)", flush=True)
        return True
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--strategy", strategy, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    try:
        r = subprocess.run(cmd, env=env, timeout=timeout,
                           capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        print(f"TIMEOUT {mesh} {arch} {shape}", flush=True)
        return False
    tail = (r.stdout or "").strip().splitlines()
    print("\n".join(tail[-2:]) if tail else f"rc={r.returncode}",
          flush=True)
    if r.returncode != 0 and not os.path.exists(path):
        os.makedirs(out, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                       "strategy": strategy, "ok": False,
                       "error": f"subprocess rc={r.returncode}",
                       "stderr_tail": (r.stderr or "")[-2000:]}, f,
                      indent=1)
    return r.returncode == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    todo = todo_list()
    t0 = time.time()
    fails = 0
    for i, (arch, shape, mp, strat) in enumerate(todo):
        print(f"--- [{i + 1}/{len(todo)}] {arch} {shape} "
              f"{'multi' if mp else 'single'} {strat} "
              f"(t={time.time() - t0:.0f}s)", flush=True)
        if not run(arch, shape, mp, strat, args.out, args.timeout):
            fails += 1
    print(f"SWEEP DONE fails={fails} t={time.time() - t0:.0f}s", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
