"""Parity of the port's recurrent families with the JAX reference on the
CPU: the building blocks of ``models/mamba.py`` (falcon-mamba-7b) and
``models/rglru.py`` (recurrentgemma-2b) on seeded numpy inputs, their
parameter trees at full width, their init, and what serving them adds
(the scan's chunk rule refused like the reference's, teacher-forced
decode against the forward, the CLI).  The models' forward, loss,
prefill / decode and ``Server`` parity are the extended cases of
tests/test_torch_models.py and tests/test_torch_serve.py.

Tolerances, stated per test:

* the depthwise conv: bf16 bit for bit (its taps are added one by one
  in bf16, as the reference adds them), f32 within 1e-6 relative;
* the scans (``selective_scan_chunked``, ``rglru_scan``) and the mixers
  (``mamba_mix``, ``rec_mix``) in f32: within ``SCAN_RTOL`` = 1e-5
  relative (elementwise, atol 1e-5 x the largest magnitude): the port
  scans in another order than ``jax.lax.associative_scan``'s, which
  moves f32 results by ~2e-7.  The exact GELU misses this bound: it
  pins jax's default tanh approximation;
* the mixers in bf16: within ``BF16_MIX_REL`` = 2^-8 (one bf16 rounding)
  in relative norm — they reproduce the reference's roundings (its
  activations op by op, the f32 reads XLA keeps unrounded), so most
  outputs are bit-equal;
* teacher-forced decode against the forward: the reference test's
  rtol = atol = 0.15.
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
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models import mamba as JMa
from repro.models import rglru as JR
from repro.models.registry import build_model as jbuild
from repro_torch import tree as T
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import flops
from repro_torch.models import mamba as M
from repro_torch.models import rglru as R
from repro_torch.models.registry import build_model as tbuild
from test_torch_models import RECURRENT, _np, close_f32, models, rel_err

ROOT = Path(__file__).resolve().parents[1]
SCAN_RTOL = 1e-5
BF16_MIX_REL = 2.0 ** -8
TF_TOL = 0.15
#: parameters of the full-width trees (the reference's ``param_specs``)
FULL_PARAMS = {"falcon-mamba-7b": 7_006_326_784,
               "recurrentgemma-2b": 2_894_574_080}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


# ---------------------------------------------------------------------------
# the depthwise conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_depthwise_conv_matches(with_carry):
    r = np.random.RandomState(0)
    x, w, b = r.randn(2, 37, 48), r.randn(4, 48), r.randn(48)
    carry = r.randn(2, 3, 48) if with_carry else None
    jf = jax.jit(JMa.causal_depthwise_conv)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = M.causal_depthwise_conv(
            _t(x, dt), _t(w, dt), _t(b),
            None if carry is None else _t(carry, dt))
        want = jf(_j(x, jdt), _j(w, jdt), _j(b),
                  None if carry is None else _j(carry, jdt))
        for g, wt in zip(got, want):
            assert g.dtype == dt
            if dt == torch.bfloat16:
                np.testing.assert_array_equal(_np(g), _np(wt))
            else:
                close_f32(_np(g), _np(wt), rtol=1e-6)


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


def _scan_inputs(S, seed=1, B=2, Di=64, N=4):
    r = np.random.RandomState(seed)
    return {"u": r.randn(B, S, Di), "dt": np.log1p(np.exp(r.randn(B, S, Di))),
            "A": -np.exp(r.randn(Di, N) * 0.5), "Bc": r.randn(B, S, N),
            "Cc": r.randn(B, S, N), "h0": r.randn(B, Di, N)}


@pytest.mark.parametrize("S", [1, 64, 256, 512])
def test_selective_scan_matches(S):
    a = _scan_inputs(S)
    y, hT = M.selective_scan_chunked(*(_t(a[k]) for k in a))
    wy, whT = jax.jit(JMa.selective_scan_chunked)(*(_j(a[k]) for k in a))
    close_f32(_np(y), _np(wy), rtol=SCAN_RTOL)
    close_f32(_np(hT), _np(whT), rtol=SCAN_RTOL)


@pytest.mark.parametrize("S", [1, 64, 256, 512])
def test_rglru_scan_matches(S):
    r = np.random.RandomState(S)
    u, a = r.randn(2, S, 48), 1.0 / (1.0 + np.exp(-r.randn(2, S, 48)))
    h0 = r.randn(2, 48)
    ut, at = _t(u), _t(a)
    y, hT = R.rglru_scan(ut, at, _t(h0))
    wy, whT = jax.jit(JR.rglru_scan)(_j(u), _j(a), _j(h0))
    close_f32(_np(y), _np(wy), rtol=SCAN_RTOL)
    close_f32(_np(hT), _np(whT), rtol=SCAN_RTOL)
    # the inputs are left as they were
    np.testing.assert_array_equal(ut.numpy(), np.float32(u))


class _Largest(TorchDispatchMode):
    """Records the most elements of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_selective_scan_holds_one_chunk_at_a_time():
    """Over 1024 positions (4 chunks) no tensor larger than one chunk's
    (B, 256, Di, N) is ever made: the (B, S, Di, N) tensor of the whole
    sequence never exists."""
    B, S, Di, N = 1, 1024, 16, 4
    a = _scan_inputs(S, B=B, Di=Di, N=N)
    args = [_t(a[k]) for k in a]
    with _Largest() as seen:
        y, _ = M.selective_scan_chunked(*args)
    assert y.shape == (B, S, Di)
    assert seen.numel == B * M.SCAN_CHUNK * Di * N < B * S * Di * N


@pytest.mark.parametrize("S", [300, 257, 513, 1000])
def test_scan_chunk_rule_refuses_what_the_reference_refuses(S):
    a = _scan_inputs(S)
    with pytest.raises(AssertionError):
        JMa.selective_scan_chunked(*(_j(a[k]) for k in a))
    with pytest.raises(AssertionError):
        JR.rglru_scan(_j(a["u"]), _j(a["dt"]), _j(a["u"][:, 0]))
    with pytest.raises(ValueError, match=str(S)):
        M.selective_scan_chunked(*(_t(a[k]) for k in a))
    with pytest.raises(ValueError, match=str(S)):
        R.rglru_scan(_t(a["u"]), _t(a["dt"]), _t(a["u"][:, 0]))


def test_scan_chunk_rule_accepts_what_the_reference_accepts():
    for S in (1, 7, 255, 256, 512, 768, 4096, 4352):
        assert M.scan_chunk(S) == min(S, M.SCAN_CHUNK)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


def _mix_params(arch, r):
    cfg = J_SMOKE[arch]
    shapes = (M.ssm_layer_shapes(cfg) if arch == "falcon-mamba-7b"
              else R.rec_shapes(cfg))
    p = {k: r.randn(*s) / np.sqrt(s[0]) for k, s in shapes.items()}
    if arch == "falcon-mamba-7b":
        p["A_log"] = np.log(np.broadcast_to(
            np.arange(1, cfg.ssm_state + 1), shapes["A_log"]))
        p["D"] = np.ones(shapes["D"])
    else:
        p["lam"] = np.linspace(0.1, 1.5, cfg.lru_width)
    return cfg, p


MIXERS = {"falcon-mamba-7b": (M.mamba_mix, JMa.mamba_mix),
          "recurrentgemma-2b": (R.rec_mix, JR.rec_mix)}


def _mix_check(got, want, dtype):
    if dtype == "float32":
        close_f32(_np(got), _np(want), rtol=SCAN_RTOL)
    else:
        assert rel_err(_np(got), _np(want)) <= BF16_MIX_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_mixer_matches_without_cache(arch, dtype):
    r = np.random.RandomState(2)
    cfg, p = _mix_params(arch, r)
    x = r.randn(2, 64, cfg.d_model)
    tmix, jmix = MIXERS[arch]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, cache = jax.jit(lambda p, x: jmix(p, x, cfg))(
        {k: _j(v) for k, v in p.items()}, _j(x, jdt))
    assert cache is None
    got = tmix({k: _t(v) for k, v in p.items()}, _t(_j(x, jdt), tdt), cfg)
    assert got.dtype == tdt
    _mix_check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_mixer_matches_with_cache(arch, dtype):
    """A 40-token prefill from zero caches, then 4 one-token decode
    steps: each step's output and the caches (written in place) against
    the reference's."""
    r = np.random.RandomState(3)
    cfg, p = _mix_params(arch, r)
    x = r.randn(2, 44, cfg.d_model)
    tmix, jmix = MIXERS[arch]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    W = cfg.ssm_conv if arch == "falcon-mamba-7b" else cfg.conv1d_width
    width = cfg.d_inner if arch == "falcon-mamba-7b" else cfg.lru_width
    h_shape = ((2, width, cfg.ssm_state) if arch == "falcon-mamba-7b"
               else (2, width))
    jcache = {"conv": jnp.zeros((2, W - 1, width), jdt),
              "h": jnp.zeros(h_shape, jnp.float32)}
    cache = {"conv": torch.zeros((2, W - 1, width), dtype=tdt),
             "h": torch.zeros(h_shape)}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    jf = jax.jit(lambda p, x, c: jmix(p, x, cfg, c))
    jp = {k: _j(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    for s0, s1 in ((0, 40), (40, 41), (41, 42), (42, 43), (43, 44)):
        xs = _j(x[:, s0:s1], jdt)
        want, jcache = jf(jp, xs, jcache)
        got = tmix(tp, _t(xs, tdt), cfg, cache)
        _mix_check(got, want, dtype)
        for k in cache:
            assert cache[k].dtype == (tdt if k == "conv" else torch.float32)
            _mix_check(cache[k], jcache[k], dtype)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs


def test_rec_mix_pins_the_tanh_gelu(monkeypatch):
    """The f32 bound separates jax's default (tanh) GELU from the exact
    one: with the exact GELU in its place, rec_mix misses it."""
    r = np.random.RandomState(2)
    cfg, p = _mix_params("recurrentgemma-2b", r)
    x = r.randn(2, 64, cfg.d_model)
    want, _ = jax.jit(lambda p, x: JR.rec_mix(p, x, cfg))(
        {k: _j(v) for k, v in p.items()}, _j(x))
    tp, tx = {k: _t(v) for k, v in p.items()}, _t(x)
    close_f32(_np(R.rec_mix(tp, tx, cfg)), _np(want), rtol=SCAN_RTOL)
    monkeypatch.setattr(R, "gelu_tanh", F.gelu)
    with pytest.raises(AssertionError):
        close_f32(_np(R.rec_mix(tp, tx, cfg)), _np(want), rtol=SCAN_RTOL)


@pytest.mark.parametrize("fn", ["sigmoid", "silu", "softplus"])
def test_activations_round_as_the_reference(fn):
    """In bf16 the activations equal jax.nn's bit for bit (each op of its
    composition rounded), and the gelu the tanh one's."""
    x = np.random.RandomState(4).randn(4096) * 4
    xb = _j(x, jnp.bfloat16)
    got = getattr(M, fn)(_t(xb, torch.bfloat16))
    np.testing.assert_array_equal(
        _np(got), _np(jax.jit(getattr(jax.nn, fn))(xb)))
    np.testing.assert_array_equal(
        _np(M.gelu_tanh(_t(xb, torch.bfloat16))),
        _np(jax.jit(jax.nn.gelu)(xb)))


# ---------------------------------------------------------------------------
# trees and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT)
def test_full_width_tree_matches_reference_specs(arch):
    """At full width and depth, on the meta device: the leaf paths (in
    the reference's order) and shapes equal the reference's
    ``param_specs``, and so does the count, which the model's
    ``active_param_count`` takes from the tree for ``flops.model_flops``
    (recurrentgemma's ``ModelConfig.param_count`` is approximate)."""
    specs = jbuild(J_ARCHS[arch]).param_specs()
    want = [("/".join(str(getattr(k, "key", k)) for k in path),
             tuple(s.shape)) for path, s in
            jax.tree_util.tree_flatten_with_path(specs)[0]]
    model = tbuild(ARCHS[arch], device="meta")
    got = [(T.path_str(p), tuple(x.shape))
           for p, x in T.leaves_with_path(model.param_tree())]
    assert got == want
    n = sum(int(np.prod(s)) for _, s in got)
    assert n == FULL_PARAMS[arch] == model.active_param_count()
    assert T.reference_leaf_paths(model.param_tree()) == [p for p, _ in got]


def test_recurrent_state_bytes_per_sequence():
    """falcon-mamba-7b's caches for one sequence: 64 layers of the f32
    (8192, 16) scan state and the bf16 (3, 8192) conv carry; a decode
    step reads and writes them."""
    model = tbuild(ARCHS["falcon-mamba-7b"], device="meta").to(
        torch.bfloat16)
    caches = model.init_cache(1, 4096)
    state = sum(t.numel() * t.element_size() for t in caches["slot0"]
                .values())
    assert state == 36_700_160
    assert flops.cache_bytes(caches) == (state, 0)
    assert flops.decode_step_bytes(1000, caches) == 1000 + 2 * state


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_model_matches_reference_distributions(arch):
    """``init_model``'s draws against the reference's ``init``: the
    constant leaves equal (``A_log``, ``D``, ``lam``, the zeros), every
    drawn leaf's std within 10% of the reference's (at width 256, so
    that the smallest leaf, a conv kernel, has 2,048 draws)."""
    wide = dict(n_layers=6, d_model=256)
    if arch == "recurrentgemma-2b":
        wide["lru_width"] = 256
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], **wide)
    model = tserve.init_model(cfg, device="cpu", seed=0,
                              dtype=torch.float32)
    ref = jbuild(dataclasses.replace(J_SMOKE[arch], **wide)).init(
        jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    for path, p in T.leaves_with_path(model.param_tree()):
        want, got = flat[T.path_str(path)], p.detach().numpy()
        if want.std() == 0:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        elif path[-1] in ("A_log", "lam"):
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert abs(got.std() - want.std()) < 0.1 * want.std(), path


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_model_draws_slice_by_slice(arch, monkeypatch):
    """Every f32 draw of ``init_model`` is one layer's slice of a stacked
    leaf (or the unstacked embedding)."""
    from repro_torch.models import layers as L
    draws = []
    real = L.init_normal

    def counted(gen, shape, std, device):
        draws.append(tuple(shape))
        return real(gen, shape, std, device)

    monkeypatch.setattr(L, "init_normal", counted)
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], n_layers=7)
    model = tserve.init_model(cfg, device="cpu", seed=0)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    embed = tuple(model.embed.shape)
    assert draws.count(embed) == 1
    assert max(int(np.prod(s)) for s in draws if s != embed) == max(
        int(np.prod(p.shape[1:])) for p in model.parameters()
        if p.dim() > 2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the forward's logits: a 40-token
    prompt, then 8 decode steps (recurrentgemma's window of 32 wraps its
    ring in prefill and again in decode)."""
    jm, params, tm = models(arch)
    toks = np.random.RandomState(5).randint(0, 256, size=(1, 48)).astype(
        np.int32)
    with torch.no_grad():
        full = _np(tm.logits(tm(torch.from_numpy(toks))))
    logits, caches = tm.prefill(torch.from_numpy(toks[:, :40]), 48)
    np.testing.assert_allclose(_np(logits[0, -1]), full[0, 39],
                               rtol=TF_TOL, atol=TF_TOL)
    for t in range(40, 48):
        logits, caches = tm.decode_step(caches, t,
                                        torch.from_numpy(toks[:, t:t + 1]))
        assert torch.isfinite(logits.float()).all()
        np.testing.assert_allclose(_np(logits[0, 0]), full[0, t],
                                   rtol=TF_TOL, atol=TF_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_server_refuses_the_prompt_the_reference_refuses(arch):
    """A 300-token prompt breaks the scan's chunk rule in both packages:
    the reference asserts, the port's Server raises a ValueError naming
    the length before any decode step."""
    jm, params, tm = models(arch)
    toks = np.zeros((1, 300), np.int32)
    with pytest.raises(AssertionError):
        jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=308)
    steps = []
    real = tm.decode_step
    tm.decode_step = lambda *a: steps.append(a) or real(*a)
    with pytest.raises(ValueError, match="300"):
        tserve.Server(tm, 308, 1).serve([tserve.Request(0, toks[0], 8)])
    assert not steps


@pytest.mark.parametrize("arch,prompt", [("recurrentgemma-2b", 40),
                                         ("falcon-mamba-7b", 48)])
def test_cli_serves_on_cpu(arch, prompt):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--arch", arch, "--requests", "3",
         "--prompt-len", str(prompt), "--new-tokens", "3"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"requests", "tokens", "wall_s", "tok_per_s"}
    assert res["requests"] == 3 and res["tokens"] == 9
