"""Parity of the port's serving path with the JAX reference on the CPU:
``prefill`` / ``decode_step`` on the five dense and the two MoE SMOKE
configs, the ports of the reference's own decode tests, ``Server.serve``
and the serve CLI.

* The reference's ``test_decode_matches_forward_dense`` (teacher-forced
  decode against one full forward, rtol = atol = 0.15 as there) and
  ``test_sliding_window_ring_cache_consistency`` (gemma2 smoke, window
  32, a 40-token prompt into a 64-position cache: the local slots' ring
  wraps in prefill and again in decode), run on the port from the
  reference's weights, and held to the reference's own logits too.
* ``prefill`` then 8 teacher-forced ``decode_step`` calls (B = 2, a
  40-token prompt, caches of 48): the logits of every step and the
  caches against the reference's — f32 within ``F32_RTOL`` = 1e-4
  relative (see tests/test_torch_models.py), bf16 within ``BF16_REL``
  = 3e-2 in relative norm.  A MoE config in bf16 is routed as the
  reference routed (``force_reference_routing`` of
  tests/test_torch_models.py: every choice it overrides a near-tie).
* MoE: teacher-forced decode against one forward (rtol = atol = 0.15)
  at the capacity factor E / K, under which no pair drops on either
  side (prefill, decode and the forward see other token counts, hence
  other capacities).
* ``Server.serve``: 8 requests of mixed prompt lengths (12-40 tokens)
  and token budgets in server batches of 4, so both chunks are
  left-padded, against the reference ``Server`` on the same weights
  (bf16 weights as the reference's ``main`` casts them, and f32).  The
  reference, teacher-forced along the port's tokens, must pick each of
  them as its argmax — in bf16, up to a tie: its logit for the port's
  token within ``TIE_ULPS`` = 2 bf16 ulps of its largest.  The greedy
  tokens equal the reference ``Server``'s for every request whose path
  holds no such tie (in f32: every request).  The smallest top-2 margin
  and the requests through a tie are printed.
* The CLI prints the reference's JSON keys; a prompt length the
  reference refuses is refused; without a card, serving raises unless
  the CPU is asked for.
* ``init_model`` draws each stacked leaf one slice of its leading axis
  at a time (no f32 draw larger than one slice), the router with std
  0.02.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import build_model as tbuild
from test_torch_models import (BF16_REL, DENSE, F32_RTOL, FRONTEND, MOE,
                               RECURRENT, close_f32, force_reference_routing,
                               frontend_inputs, models, rel_err, _np)

ROOT = Path(__file__).resolve().parents[1]
#: the reference test's teacher-forced tolerance
TF_TOL = 0.15
#: bf16 serving: two logits within this many bf16 ulps of the row's
#: largest are a tie under rounding, which either package may break
TIE_ULPS = 2


def _check(got, want, dtype):
    if dtype == "float32":
        close_f32(_np(got), _np(want), F32_RTOL)
    else:
        assert rel_err(_np(got), _np(want)) < BF16_REL


def _full_logits(tm, toks):
    with torch.no_grad():
        return tm.logits(tm(torch.from_numpy(np.array(toks))))


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
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_prefill_decode_match_reference(arch, dtype, monkeypatch):
    """A frontend arch prefills with seeded non-zero frames / patch
    embeddings; the VLM's caches hold its patches first, and its decode
    positions follow them."""
    jm, params, tm = models(arch, dtype)
    r = np.random.RandomState(11)
    toks = r.randint(0, SMOKE_ARCHS[arch].vocab_size,
                     size=(2, 48)).astype(np.int32)
    extra = frontend_inputs(arch, 40)
    off = tm.n_prefix
    jpre = jax.jit(jm.prefill, static_argnums=2)
    jdec = jax.jit(jm.decode_step)
    with force_reference_routing(arch, dtype, monkeypatch):
        jlogits, jcache = jpre(params, {"tokens": jnp.asarray(
            toks[:, :40]), **{k: jnp.asarray(v) for k, v in extra.items()}},
            off + 48)
        logits, cache = tm.prefill(
            torch.from_numpy(toks[:, :40]), cache_len=off + 48,
            **{k: torch.from_numpy(v) for k, v in extra.items()})
        assert logits.shape == tuple(jlogits.shape)
        _check(logits, jlogits, dtype)
        for t in range(40, 48):
            jlogits, jcache = jdec(params, jcache, jnp.int32(off + t),
                                   jnp.asarray(toks[:, t:t + 1]))
            logits, cache = tm.decode_step(
                cache, off + t, torch.from_numpy(toks[:, t:t + 1]))
            _check(logits, jlogits, dtype)
    for slot, kv in jcache.items():
        for name, want in kv.items():
            got = cache[slot][name]
            assert tuple(got.shape) == tuple(want.shape)
            _check(got, want, dtype)


#: (prompt length, max_new_tokens) of the 8 served requests
REQS = [(40, 6), (33, 6), (17, 4), (40, 6), (25, 6), (38, 2), (12, 6),
        (40, 5)]


def _requests(mod, vocab):
    r = np.random.RandomState(3)
    return [mod.Request(i, r.randint(0, vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(REQS)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_server_tokens_match_reference(arch, dtype, monkeypatch):
    """The VLM is held to the reference's model-level prefill and decode
    at the port's positions, n_patches + t, in a ring that holds its
    patches too: the reference ``Server`` decodes it from the wrong
    position (R8), so its tokens are not compared."""
    jm, params, tm = models(arch, None if dtype == "bfloat16" else dtype)
    if dtype == "bfloat16":
        # the reference's main casts the weights once
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        tm.to(torch.bfloat16)
    cache_len = max(n for n, _ in REQS) + max(m for _, m in REQS)
    V = tm.cfg.vocab_size
    want = (None if tm.n_prefix else jserve.Server(jm, cache_len, 4).serve(
        params, _requests(jserve, V)))
    cache_len += tm.n_prefix

    # the reference teacher-forced along the port's tokens, one call
    # ahead of the port's (a MoE port in bf16 routes as it did): each
    # token the port chose is the reference's argmax (bf16: within
    # TIE_ULPS of it)
    jpre = jax.jit(jm.prefill, static_argnums=2)
    jdec = jax.jit(jm.decode_step)
    margins, ties = [], set()
    ref = {"chunk": -1}

    def check(fed):
        c, step = ref["chunk"], ref["step"]
        logits = np.asarray(ref["logits"][:, -1, :V], np.float64)
        for j, rid in enumerate(range(4 * c, 4 * c + 4)):
            if step >= REQS[rid][1]:
                continue
            row, srt = logits[j], np.sort(logits[j])
            tie = (TIE_ULPS * bf16_ulp(srt[-1])
                   if dtype == "bfloat16" else 0.0)
            assert row[int(fed[j, 0])] >= srt[-1] - tie, (rid, step)
            margins.append(srt[-1] - srt[-2])
            if margins[-1] <= tie:
                ties.add(rid)

    def lockstep(fn, prefill):
        def f(*a, **inputs):
            if prefill:
                toks, clen = a
                ref["chunk"] += 1
                ref["step"] = 0
                ref["logits"], ref["cache"] = jpre(
                    params, {"tokens": jnp.asarray(toks.numpy()),
                             **{k: jnp.asarray(v.numpy())
                                for k, v in inputs.items()}}, clen)
            else:
                _, t, fed = a
                check(fed)
                ref["logits"], ref["cache"] = jdec(
                    params, ref["cache"], jnp.int32(t),
                    jnp.asarray(fed.numpy(), jnp.int32))
                ref["step"] += 1
            return fn(*a, **inputs)
        return f

    with force_reference_routing(arch, dtype, monkeypatch):
        tm.prefill = lockstep(tm.prefill, True)
        tm.decode_step = lockstep(tm.decode_step, False)
        got = tserve.Server(tm, cache_len, 4).serve(_requests(tserve, V))
    assert [len(r.out_tokens) for r in got] == [m for _, m in REQS]
    assert all(r.t_done >= r.t_submit > 0 for r in got)
    assert ref["chunk"] == 1
    print(f"{arch} {dtype}: smallest top-2 margin of the reference's "
          f"logits along the port's tokens {min(margins):.4g}; requests "
          f"through a bf16 tie {sorted(ties)}")
    for r, w in zip(got, want or got):
        if r.rid not in ties:
            assert r.out_tokens == w.out_tokens, r.rid


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


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


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


@pytest.mark.parametrize("arch", ["gemma2-9b"] + MOE)
def test_init_model_draws_slice_by_slice(arch, monkeypatch):
    """Every f32 draw of ``init_model`` is one slice of a stacked leaf
    (or the embedding, which is not stacked); each stacked leaf's slices
    come from ``n_groups`` draws; the router's std is 0.02 and the expert
    weights' 1 / sqrt(shape[-2])."""
    from repro_torch.models import layers as L
    draws = []
    real = L.init_normal

    def counted(gen, shape, std, device):
        draws.append(tuple(shape))
        return real(gen, shape, std, device)

    monkeypatch.setattr(L, "init_normal", counted)
    # 4 layers: at least two slices in every stack (gemma2: 2 groups)
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], n_layers=4)
    model = tserve.init_model(cfg, device="cpu", seed=0)
    embed = tuple(model.embed.shape)
    want = [tuple(p.shape[1:]) for slot in model.blocks.values()
            for k, p in list(slot.attn.items()) + list(slot.ffn.items())
            for _ in range(p.shape[0]) if k.startswith("w") or k == "router"]
    assert sorted(draws) == sorted(want + [embed])
    assert model.n_groups >= 2
    if arch in MOE:
        ffn = model.blocks["slot0"].ffn
        r = ffn["router"].detach().float()
        assert abs(float(r.std()) - 0.02) < 0.1 * 0.02
        assert float(r.abs().max()) > 0
        for k in ("w_gate", "w_up", "w_down"):
            w = ffn[k].detach().float()
            std = w.shape[-2] ** -0.5
            assert abs(float(w.std()) - std) < 0.1 * std, k
