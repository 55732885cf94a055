"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``repro`` — checked statically over every import statement, and
dynamically in a fresh interpreter that imports the whole port and then
inspects ``sys.modules``.  And ``chip_smoke.py`` refuses to run without a
card, or without the repo around it, printing no result."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(("repro_torch",) + parts))
    return out


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, runpy, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, "
            "run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print('BAD', bad) if bad else print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN"), out.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _building_blocks():
    """Each public building block that puts tensors on a device, called
    without a device argument."""
    from repro_torch.configs.base import ACESyncConfig
    from repro_torch.core import acesync, importance, knapsack, planexec
    from repro_torch.core.scheduler import Scheduler
    cfg, sizes = ACESyncConfig(), [2048, 1024]
    sched = Scheduler(cfg, sizes, 1, device="cpu")
    plan = sched.plan_from_levels([0, 1], (1.0,))
    gen = torch.Generator().manual_seed(0)
    meta = [{"depth": 0.0, "size": 2048, "kind": "attn"}]
    return {
        "Scheduler": lambda: Scheduler(cfg, sizes, 1),
        "build_exec_plan": lambda: planexec.build_exec_plan(plan, sizes),
        "make_device_solver": lambda: knapsack.make_device_solver(
            sizes, sched.levels, 2),
        "acesync.init_state": lambda: acesync.init_state(
            gen, {"w": torch.zeros(4)}, [], cfg),
        "importance.init_params": lambda: importance.init_params(gen, 2, 4),
        "importance.init_state": lambda: importance.init_state(gen, 2, 4),
        "importance.structural_features": lambda:
            importance.structural_features(meta),
    }


@pytest.mark.parametrize("name", sorted(_building_blocks()))
def test_building_blocks_default_to_cuda(name):
    """Without a device argument every building block asks for the card,
    and raises here instead of putting its tensors on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _building_blocks()[name]()
