"""Parity of the port's serving path with the JAX reference on the CPU for
the dense zoo (SMOKE paper-350m, qwen3-8b, gemma2-9b, minitron-8b,
starcoder2-3b), and the family-independent cases: the reference's two
decode tests ported (teacher-forced decode against one forward, the
sliding-window ring), ``prefill`` / ``decode_step`` logits and caches
per step and the ``Server`` against the reference, the CLI's JSON keys,
the refused prompt length, serving's default device and ``init_model``'s
leaf-by-leaf draws.  The shared bodies and their tolerances:
``tests/torch_serve_ref.py``; the other families:
``tests/test_torch_serve_{moe,recurrent,frontend}.py``."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from test_torch_models import DENSE, BF16_REL, close_f32, models, _np
import torch_serve_ref as V
from torch_serve_ref import ROOT, TF_TOL, _check, _full_logits


def test_decode_matches_forward_dense():
    """Teacher-forced decode reproduces the forward logits (paper-350m
    smoke): cache writes, ring positions and RoPE offsets."""
    jm, params, tm = models("paper-350m")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (1, 16), 0,
                                         256))
    full = _np(_full_logits(tm, toks))
    jfull = _np(JL.lm_logits(jm.forward(params, {"tokens": jnp.asarray(
        toks)}), params["embed"], jm.cfg))
    close_f32(full, jfull, BF16_REL)
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :8]), cache_len=16)
    np.testing.assert_allclose(_np(logits[0, -1]), full[0, 7], rtol=TF_TOL,
                               atol=TF_TOL)
    for t in range(8, 16):
        logits, cache = tm.decode_step(cache, t,
                                       torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(logits[0, 0]), full[0, t],
                                   rtol=TF_TOL, atol=TF_TOL)


def test_sliding_window_ring_cache_consistency():
    """gemma2 smoke (window 32): decode beyond the window allocation stays
    finite and teacher-forced matches the forward and the reference's
    decode."""
    jm, params, tm = models("gemma2-9b")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (1, 48), 0,
                                         256))
    full = _np(_full_logits(tm, toks))
    _, cache = tm.prefill(torch.from_numpy(toks[:, :40]), cache_len=64)
    _, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :40])},
                           cache_len=64)
    assert cache["slot0"]["k"].shape[2] == 32      # local: the window
    assert cache["slot1"]["k"].shape[2] == 64      # global: the cache
    for t in range(40, 48):
        logits, cache = tm.decode_step(cache, t,
                                       torch.from_numpy(toks[:, t:t + 1]))
        jlogits, jcache = jm.decode_step(params, jcache, jnp.int32(t),
                                         jnp.asarray(toks[:, t:t + 1]))
        assert torch.isfinite(logits.float()).all()
        np.testing.assert_allclose(_np(logits[0, 0]), full[0, t],
                                   rtol=TF_TOL, atol=TF_TOL)
        _check(logits, jlogits, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_match_reference(arch, dtype, monkeypatch):
    V.check_prefill_decode_match_reference(arch, dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_server_tokens_match_reference(arch, dtype, monkeypatch):
    V.check_server_tokens_match_reference(arch, dtype, monkeypatch)


def test_refuses_the_prompt_lengths_the_reference_refuses():
    jm, params, tm = models("paper-350m")
    toks = np.zeros((1, 1500), np.int32)
    with pytest.raises(AssertionError):
        jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=1508)
    server = tserve.Server(tm, 1508, 1)
    with pytest.raises(ValueError, match="1500"):
        server.serve([tserve.Request(0, toks[0], 8)])


def test_cli_prints_the_reference_keys():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--arch", "gemma2-9b", "--requests", "3",
         "--prompt-len", "40", "--new-tokens", "3"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"requests", "tokens", "wall_s", "tok_per_s"}
    assert res["requests"] == 3 and res["tokens"] == 9


def test_init_model_casts_leaf_by_leaf():
    """``init_model`` gives every Parameter in the serving dtype on the
    device, with the reference's distributions."""
    cfg = SMOKE_ARCHS["gemma2-9b"]
    model = tserve.init_model(cfg, device="cpu", seed=0)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model.device == torch.device("cpu")
    w = model.blocks["slot1"].ffn["w_down"].detach().float()
    assert abs(float(w.std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert float(model.blocks["slot0"].ln1_post.abs().max()) == 0.0


def test_serving_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.init_model(SMOKE_ARCHS["qwen3-8b"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--requests", "1"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert '"tokens"' not in out.stdout


@pytest.mark.parametrize("arch", ["gemma2-9b"])
def test_init_model_draws_slice_by_slice(arch, monkeypatch):
    V.check_init_model_draws_slice_by_slice(arch, monkeypatch)
