"""Parity of the port's serving path with the JAX reference on the CPU for
the MoE family (SMOKE qwen3-moe-30b-a3b, dbrx-132b): teacher-forced
decode against one forward at the capacity factor E / K, ``prefill`` /
``decode_step`` and the ``Server`` against the reference (bf16 routed
as the reference routed), the CLI on the CPU and by default on the
card, ``init_model``'s draws.  The shared bodies and their tolerances:
``tests/torch_serve_ref.py``."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from test_torch_models import MOE, models, _np
import torch_serve_ref as V
from torch_serve_ref import ROOT, TF_TOL, _full_logits


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_without_drops(arch):
    """Teacher-forced decode reproduces the forward logits (MoE smoke) at
    the capacity factor E / K: C >= T at every step, so no pair drops in
    prefill (T = 16), decode (T = 1) or the forward (T = 32)."""
    jm, params, tm = models(arch)
    cfg = tm.cfg
    tm.cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (1, 32), 0,
                                         256))
    full = _np(_full_logits(tm, toks))
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :16]), cache_len=32)
    np.testing.assert_allclose(_np(logits[0, -1]), full[0, 15], rtol=TF_TOL,
                               atol=TF_TOL)
    for t in range(16, 32):
        logits, cache = tm.decode_step(cache, t,
                                       torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(logits[0, 0]), full[0, t],
                                   rtol=TF_TOL, atol=TF_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_match_reference(arch, dtype, monkeypatch):
    V.check_prefill_decode_match_reference(arch, dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_server_tokens_match_reference(arch, dtype, monkeypatch):
    V.check_server_tokens_match_reference(arch, dtype, monkeypatch)


@pytest.mark.parametrize("arch", MOE)
def test_moe_cli_serves_on_cpu_and_defaults_to_cuda(arch):
    """The serve CLI takes the MoE archs: on the CPU when asked (the
    reference's JSON keys), and on the card by default, raising without
    one, as ``init_model`` does."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--arch", arch, "--requests", "2", "--prompt-len", "24",
           "--new-tokens", "3"]
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"requests", "tokens", "wall_s", "tok_per_s"}
    assert res["requests"] == 2 and res["tokens"] == 6
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.init_model(SMOKE_ARCHS[arch])
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert '"tokens"' not in out.stdout


@pytest.mark.parametrize("arch", MOE)
def test_init_model_draws_slice_by_slice(arch, monkeypatch):
    V.check_init_model_draws_slice_by_slice(arch, monkeypatch)
