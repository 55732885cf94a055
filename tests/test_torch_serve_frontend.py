"""Parity of the port's serving path with the JAX reference on the CPU for
the encoder-decoder and the VLM (SMOKE seamless-m4t-medium,
llava-next-mistral-7b), fed seeded non-zero frames / patch embeddings:
``prefill`` / ``decode_step`` logits and caches per step, the
``Server`` against the reference's model-level calls, the cross K/V
cache, the VLM's decode after its patches (R8) and the CLI.  The shared
bodies and their tolerances: ``tests/torch_serve_ref.py``."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve
from test_torch_models import FRONTEND, close_f32, frontend_inputs, models, _np
import torch_serve_ref as V
from torch_serve_ref import ROOT, _requests


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND)
def test_prefill_decode_match_reference(arch, dtype, monkeypatch):
    V.check_prefill_decode_match_reference(arch, dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND)
def test_server_tokens_match_reference(arch, dtype, monkeypatch):
    V.check_server_tokens_match_reference(arch, dtype, monkeypatch)


def test_cross_cache_matches_reference():
    """seamless-m4t-medium's prefill writes each decoder layer's cross
    K/V of the encoder's output (seeded non-zero frames) once: f32 equal
    to the reference's within 1e-4 relative, non-zero, and untouched by
    the decode steps after it."""
    jm, params, tm = models("seamless-m4t-medium", "float32")
    toks = np.random.RandomState(12).randint(0, 256, size=(2, 24)) \
        .astype(np.int32)
    frames = frontend_inputs("seamless-m4t-medium", 24)["frames"]
    _, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(frames)}, 32)
    _, cache = tm.prefill(torch.from_numpy(toks), 32,
                          frames=torch.from_numpy(frames))
    assert tuple(cache["cross"]["k"].shape) == (2, 2, 64, 4, 16)
    before = {k: v.clone() for k, v in cache["cross"].items()}
    for name, want in jcache["cross"].items():
        close_f32(_np(cache["cross"][name]), _np(want))
        assert float(cache["cross"][name].abs().min()) > 0
    for t in range(24, 28):
        _, cache = tm.decode_step(cache, t, torch.from_numpy(toks[:, :1]))
    for name, c in cache["cross"].items():
        assert torch.equal(c, before[name])


def test_vlm_server_decodes_after_the_patches(monkeypatch):
    """R8: the reference's ``Server`` prefills the VLM's n_patches + S
    positions but starts decode at S, and its CLI's ring (prompt + new
    tokens) drops the patches; the port's ``Server`` starts decode at
    n_patches + S and its CLI sizes the ring at n_patches + prompt + new
    tokens."""
    jm, params, tm = models("llava-next-mistral-7b", "float32")
    P = tm.cfg.n_patches
    seen, jseen = [], []
    real = tm.decode_step

    def counted(caches, t, tokens):
        seen.append(t)
        return real(caches, t, tokens)

    monkeypatch.setattr(tm, "decode_step", counted)
    reqs = _requests(tserve, 256)[:4]
    tserve.Server(tm, P + 46, 4).serve(reqs)
    S = max(len(r.prompt) for r in reqs)
    assert seen == list(range(P + S, P + S + 6))
    jsrv = jserve.Server(jm, 46, 4)
    jdec = jsrv._decode

    def jcounted(p, caches, t, tokens):
        jseen.append(int(t))
        return jdec(p, caches, t, tokens)

    jsrv._decode = jcounted
    jsrv.serve(params, _requests(jserve, 256)[:4])
    assert jseen == list(range(S, S + 6))
    monkeypatch.setattr(tserve, "Server", _RingSize)
    tserve.main(["--smoke", "--arch", "llava-next-mistral-7b", "--device",
                 "cpu", "--requests", "1", "--prompt-len", "24",
                 "--new-tokens", "2"])
    assert _RingSize.sizes == [P + 24 + 2]


class _RingSize(tserve.Server):
    """The serve CLI's Server, its ring size recorded."""
    sizes = []

    def __init__(self, model, cache_len, batch):
        _RingSize.sizes.append(cache_len)
        super().__init__(model, cache_len, batch)


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_cli_serves_on_cpu(arch):
    """The serve CLI takes seamless-m4t-medium and llava-next-mistral-7b
    (their SMOKE configs on the CPU): the reference's JSON keys, every
    token."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--arch", arch, "--requests", "3", "--prompt-len", "40",
         "--new-tokens", "3"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"requests", "tokens", "wall_s", "tok_per_s"}
    assert res["requests"] == 3 and res["tokens"] == 9
