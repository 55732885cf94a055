"""Parity of the port's model zoo with the JAX reference on the CPU: the
attention and cache building blocks of ``models/layers.py`` on seeded
numpy inputs, and each of the five dense SMOKE configs (paper-350m,
qwen3-8b, gemma2-9b, minitron-8b, starcoder2-3b) and the two MoE ones
(qwen3-moe-30b-a3b, dbrx-132b): the parameter tree (paths and shapes
equal to the reference's ``model.init`` tree), and ``forward`` and
``loss`` from the reference's own weights.

Tolerances, stated per test:

* f32 (``dtype="float32"`` on both sides): within ``F32_RTOL`` = 1e-4
  relative — elementwise ``rtol`` 1e-4 with an ``atol`` of 1e-4 times
  the largest magnitude of the reference's tensor;
* bf16 (the configs' compute dtype): the two frameworks round matmul
  outputs at other points (and the port's unsoftcapped attention is
  SDPA), so hidden states agree to ``BF16_REL`` = 3e-2 in relative
  Frobenius norm and losses to ``LOSS_RTOL`` = 2e-2 relative (the
  trainer parity tests' bound);
* ring positions, ring writes and the bf16 embedding lookup are exact;
* MoE in bf16: the router's top-k is a discontinuous choice, and the
  bf16 roundings that the two frameworks place differently move a
  logit by ~1e-3, enough to swap an expert at a near-tie, after which
  the token's FFN output differs by O(1).  So in bf16 the port is
  made to route as the reference did (:func:`force_reference_routing`):
  the reference records each dispatch's experts and router logits, the
  port takes the experts (its gates from its own logits), and the test
  holds the two packages' router logits within ``BF16_REL`` of their
  largest magnitude: every logit moves by at most that, so each choice
  the port would have made otherwise lies within twice that of a tie.
  In f32 nothing is forced: the routes agree.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from repro_torch.models.registry import build_model as tbuild

DENSE = ["paper-350m", "qwen3-8b", "gemma2-9b", "minitron-8b",
         "starcoder2-3b"]
MOE = ["qwen3-moe-30b-a3b", "dbrx-132b"]
RECURRENT = ["falcon-mamba-7b", "recurrentgemma-2b"]
#: the archs behind a frontend stub: the encoder-decoder (frames) and the
#: VLM (patch embeddings)
FRONTEND = ["seamless-m4t-medium", "llava-next-mistral-7b"]
F32_RTOL = 1e-4
BF16_REL = 3e-2
LOSS_RTOL = 2e-2
B, S = 2, 64


def close_f32(got, want, rtol=F32_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(x):
    """A torch or jax tensor as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _qkv(seed, Sq, Sk, H=4, KV=2, Dh=16, dtype=np.float32):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, H, Dh).astype(dtype),
            r.randn(B, Sk, KV, Dh).astype(dtype),
            r.randn(B, Sk, KV, Dh).astype(dtype))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap_matches(cap):
    x = np.random.RandomState(0).randn(4, 257).astype(np.float32) * 40
    close_f32(L.softcap(torch.from_numpy(x), cap),
              JL.softcap(jnp.asarray(x), cap), rtol=1e-6)
    # bf16 in, bf16 out: the same two roundings (x / cap, then * cap)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = _np(L.softcap(xb, cap))
    want = _np(JL.softcap(jnp.asarray(x, jnp.bfloat16), cap))
    assert np.abs(got - want).max() <= (0.0 if cap is None else
                                        2 ** -7 * np.abs(want).max())


#: (causal, window, softcap, Sq, q_chunk, kv_chunk): chunked so that
#: whole chunk pairs fall outside the causal or window mask (skipped by
#: the port, wiped or added as zeros by the reference)
ATTN_CASES = [
    (True, None, None, 64, 16, 16),
    (True, None, 50.0, 64, 16, 32),
    (True, 20, 50.0, 64, 16, 16),
    (True, 16, None, 64, 32, 8),
    (False, None, 30.0, 48, 48, 16),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_chunked_attention_matches(case):
    causal, window, cap, Sq, qc, kc = case
    q, k, v = _qkv(1, Sq, Sq)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_chunk=qc,
              kv_chunk=kc)
    got = L.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    close_f32(got, want)
    # bf16 inputs: p is rounded to bf16 before PV on both sides
    qb, kb, vb = (x.astype(jnp.bfloat16) for x in map(jnp.asarray,
                                                       (q, k, v)))
    got = L.chunked_attention(*(torch.from_numpy(np.array(
        x.astype(jnp.float32))).to(torch.bfloat16) for x in (qb, kb, vb)),
        **kw)
    assert rel_err(_np(got), _np(JL.chunked_attention(qb, kb, vb, **kw))) \
        < 1e-2


@pytest.mark.parametrize("window", [None, 16])
def test_sdpa_attention_matches_chunked(window):
    """The unsoftcapped path (SDPA, with the window as a mask) computes
    the reference's chunked attention."""
    q, k, v = _qkv(2, S, S)
    got = L.causal_attention(*map(torch.from_numpy, (q, k, v)), window)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), window=window,
                                q_chunk=16, kv_chunk=16)
    close_f32(got, want)


@pytest.mark.parametrize("shape", [(1500, 2048, 1024), (4608, 2048, 1024),
                                   (40, 16, 16), (48, 32, 16)])
def test_chunk_rule_refuses_what_the_reference_refuses(shape):
    Sq, qc, kc = shape
    q, k, v = (np.zeros((1, Sq, 1, 4), np.float32) for _ in range(3))
    with pytest.raises(AssertionError):
        JL.chunked_attention(*map(jnp.asarray, (q, k, v)), q_chunk=qc,
                             kv_chunk=kc)
    with pytest.raises(ValueError):
        L.chunked_attention(*map(torch.from_numpy, (q, k, v)), q_chunk=qc,
                            kv_chunk=kc)
    with pytest.raises(ValueError):
        L.check_chunks(Sq, Sq, qc, kc)


def test_chunk_rule_accepts_what_the_reference_accepts():
    for Sq in (1, 7, 512, 1000, 1024, 2048, 4096, 6144):
        L.check_chunks(Sq, Sq, 2048, 1024)


@pytest.mark.parametrize("alloc", [1, 8, 13])
def test_ring_slot_positions_match(alloc):
    for t in (0, 3, 7, 8, 12, 31, 100):
        np.testing.assert_array_equal(
            L.ring_slot_positions(t, alloc).numpy(),
            np.asarray(JL.ring_slot_positions(jnp.int32(t), alloc)))


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (13, 8), (40, 32),
                                 (19, 4)])
def test_ring_write_prefill_matches(S, W):
    r = np.random.RandomState(S * W)
    kv = r.randn(B, S, 2, 4).astype(np.float32)
    cache = r.randn(B, W, 2, 4).astype(np.float32)
    ct = torch.from_numpy(cache.copy())
    out = L.ring_write_prefill(ct, torch.from_numpy(kv))
    assert out is ct
    np.testing.assert_array_equal(
        ct.numpy(), np.asarray(JL.ring_write_prefill(jnp.asarray(cache),
                                                     jnp.asarray(kv))))


def test_ring_write_decode_matches_in_place():
    r = np.random.RandomState(3)
    cache = r.randn(B, 8, 2, 4).astype(np.float32)
    ct = torch.from_numpy(cache.copy())
    ptr = ct.data_ptr()
    want = jnp.asarray(cache)
    for t in (0, 5, 8, 13, 23):
        kv = r.randn(B, 1, 2, 4).astype(np.float32)
        assert L.ring_write_decode(ct, torch.from_numpy(kv), t) is ct
        want = JL.ring_write_decode(want, jnp.asarray(kv), jnp.int32(t))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(want))
    assert ct.data_ptr() == ptr


#: (alloc, t, window, softcap): the ring not yet full, full, wrapped
DECODE_CASES = [(16, 5, None, None), (16, 15, None, 50.0),
                (16, 40, None, None), (8, 21, 6, 50.0), (32, 32, 32, 50.0)]


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_attention_matches(case):
    alloc, t, window, cap = case
    q, k, v = _qkv(4, 1, alloc)
    kw = dict(window=window, logit_softcap=cap)
    got = L.decode_attention(*map(torch.from_numpy, (q, k, v)), t, **kw)
    close_f32(got, JL.decode_attention(*map(jnp.asarray, (q, k, v)),
                                       jnp.int32(t), **kw))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    got = L.decode_attention(*(torch.from_numpy(np.array(
        x.astype(jnp.float32))).to(torch.bfloat16) for x in (qb, kb, vb)),
        t, **kw)
    assert rel_err(_np(got), _np(JL.decode_attention(
        qb, kb, vb, jnp.int32(t), **kw))) < 1e-2


#: (Sq, Sk, q_chunk, kv_chunk): self-attention (Sq == Sk) and
#: cross-attention over fewer or more keys than queries
BIDIR_CASES = [(48, 48, 2048, 1024), (40, 64, 2048, 1024),
               (64, 16, 2048, 1024), (32, 96, 16, 32)]


def _attn_weights(cfg, seed):
    r = np.random.RandomState(seed)
    return {k: (r.randn(*s[1:]) * s[-2] ** -0.5).astype(np.float32)
            for k, s in L.attn_shapes(cfg, 1).items()}


@pytest.mark.parametrize("case", BIDIR_CASES, ids=str)
def test_bidirectional_and_cross_attention_match(case):
    """``attn_apply(causal=False)`` (the encoder's self-attention, with
    RoPE) and ``cross_attn_apply`` (queries from x, keys and values from
    mem, no RoPE) against the reference's, in f32 within 1e-5 relative;
    the cross K/V a cache takes are the reference's prefill ones."""
    Sq, Sk, qc, kc = case
    cfg = SMOKE_ARCHS["seamless-m4t-medium"]
    p = _attn_weights(cfg, Sq * Sk)
    r = np.random.RandomState(Sq + Sk)
    x = r.randn(B, Sq, cfg.d_model).astype(np.float32)
    mem = r.randn(B, Sk, cfg.d_model).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    kw = dict(q_chunk=qc, kv_chunk=kc)
    cache = {k: torch.zeros((B, Sk, cfg.n_kv_heads, cfg.head_dim))
             for k in ("k", "v")}
    got = L.cross_attn_apply(tp, torch.from_numpy(x), torch.from_numpy(mem),
                             cfg, cache=cache, **kw)
    want = JL.cross_attn_apply(jp, jnp.asarray(x), jnp.asarray(mem), cfg,
                               **kw)
    close_f32(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        cache["k"].numpy(), (mem @ p["wk"]).reshape(cache["k"].shape),
        rtol=1e-5, atol=1e-5 * float(np.abs(mem @ p["wk"]).max()))
    if Sq == Sk:
        pos = np.broadcast_to(np.arange(Sq)[None], (B, Sq))
        got = L.attn_apply(tp, torch.from_numpy(x), cfg,
                           positions=torch.from_numpy(pos.copy()),
                           causal=False, **kw)
        want, _ = JL.attn_apply(jp, jnp.asarray(x), cfg,
                                positions=jnp.asarray(pos), causal=False,
                                **kw)
        close_f32(got, want, rtol=1e-5)
    # a decode token over the cross cache: every slot visible
    q1 = torch.from_numpy(x[:, :1])
    got = L.cross_attn_decode(tp, q1, cache, cfg)
    want = JL.cross_attn_apply(jp, jnp.asarray(x[:, :1]), jnp.asarray(mem),
                               cfg, **kw)
    close_f32(got, want, rtol=1e-5)


def test_cross_attention_keeps_the_chunk_rule():
    """Cross-attention over a key count the reference's chunks refuse is
    refused."""
    cfg = SMOKE_ARCHS["seamless-m4t-medium"]
    tp = {k: torch.from_numpy(v) for k, v in _attn_weights(cfg, 0).items()}
    x = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(ValueError, match="1500"):
        L.cross_attn_apply(tp, x, torch.zeros((1, 1500, cfg.d_model)), cfg)


@pytest.mark.parametrize("d_model", [64, 3584])
def test_embed_lookup_matches(d_model):
    cfg = dataclasses.replace(SMOKE_ARCHS["gemma2-9b"], d_model=d_model)
    r = np.random.RandomState(5)
    emb = (r.randn(256, d_model) * 0.02).astype(np.float32)
    toks = r.randint(0, 256, size=(B, 9)).astype(np.int32)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = L.embed_lookup(torch.from_numpy(emb), torch.from_numpy(toks),
                             cfg, dt)
        want = JL.embed_lookup(jnp.asarray(emb), jnp.asarray(toks), cfg, jdt)
        np.testing.assert_array_equal(_np(got), _np(want))
    # the scale is sqrt(d) rounded to bf16 (59.75 for d = 3584)
    scale = float(torch.tensor(math.sqrt(d_model), dtype=torch.bfloat16))
    assert scale == float(jnp.asarray(math.sqrt(d_model), jnp.bfloat16))


# ---------------------------------------------------------------------------
# the five dense SMOKE configs
# ---------------------------------------------------------------------------


def _key(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)


def ref_flat(params) -> dict:
    return {_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}


def models(arch, dtype=None, seed=0):
    """(reference model, its params, port model loaded with them)."""
    cfg, jcfg = SMOKE_ARCHS[arch], J_SMOKE[arch]
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(cfg, device="cpu")
    convert.params_from_reference(ref_flat(params), tm)
    return jm, params, tm


class RouteLog:
    """The reference's routes, recorded as it dispatches, and the port's
    dispatches made to take them (see the module doc)."""

    def __init__(self):
        self.ref = []        # (eidx, logits) per reference dispatch
        self.flips = 0       # (token, layer) sets the port would change
        self.n = 0           # port dispatches forced

    def ref_dispatch(self, real):
        def f(xf, logits, cfg, C):
            out = real(xf, logits, cfg, C)
            jax.debug.callback(
                lambda e, lg: self.ref.append((np.asarray(e),
                                               np.asarray(lg))),
                out[1], logits, ordered=True)
            return out
        return f

    def port_route(self, real):
        def f(logits, k):
            jax.effects_barrier()
            own = real(logits, k)[1]
            ref_e, ref_l = self.ref.pop(0)
            ref_e = torch.from_numpy(np.array(ref_e)).long()
            gap = float(np.abs(logits.detach().numpy() - ref_l).max())
            assert gap <= BF16_REL * float(np.abs(ref_l).max()), gap
            at_ref = logits.gather(1, ref_e)
            self.flips += int((own.sort(1)[0] != ref_e.sort(1)[0])
                              .any(1).sum())
            self.n += 1
            return torch.softmax(at_ref, dim=-1), ref_e
        return f


@contextlib.contextmanager
def force_reference_routing(arch, dtype, monkeypatch):
    """For a MoE arch in bf16: the port routes as the reference did (each
    reference call first, then the port's); yields the :class:`RouteLog`
    (None otherwise: nothing is patched)."""
    if arch not in MOE or dtype == "float32":
        yield None
        return
    log = RouteLog()
    with monkeypatch.context() as m:
        m.setattr(JM, "_dispatch_local", log.ref_dispatch(
            JM._dispatch_local))
        m.setattr(TM, "route", log.port_route(TM.route))
        yield log
    jax.effects_barrier()
    assert not log.ref and log.n, "every reference dispatch was taken"
    print(f"{arch}: {log.n} dispatches routed as the reference; "
          f"{log.flips} (token, layer) top-k sets at a near-tie")


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT + FRONTEND)
def test_param_tree_matches_reference_init(arch):
    params = jbuild(J_SMOKE[arch]).init(jax.random.PRNGKey(0))
    want = [(_key(p), tuple(x.shape)) for p, x in
            jax.tree_util.tree_flatten_with_path(params)[0]]
    model = tbuild(SMOKE_ARCHS[arch], device="cpu")
    got = [(T.path_str(p), tuple(x.shape))
           for p, x in T.leaves_with_path(model.param_tree())]
    assert got == want
    # the module's own parameters are exactly the tree's leaves
    assert {id(p) for p in model.parameters()} == \
        {id(x) for x in T.leaves(model.param_tree())}
    # the yardstick's N (``flops.model_flops``): the tree's count, a MoE's
    # less the experts a token is not routed to, as the reference's
    # config counts its active parameters
    cfg, n = J_SMOKE[arch], sum(math.prod(s) for _, s in want)
    assert model.active_param_count() == \
        cfg.active_param_count() + n - cfg.param_count()


def test_params_from_reference_refuses_other_paths():
    _, params, tm = models("qwen3-8b")
    flat = ref_flat(params)
    flat.pop("blocks/slot0/attn/q_norm")
    with pytest.raises(ValueError, match="q_norm"):
        convert.params_from_reference(flat, tm)


def _tokens(arch, seed=1, n=S):
    r = np.random.RandomState(seed)
    return r.randint(0, SMOKE_ARCHS[arch].vocab_size,
                     size=(B, n)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_forward_and_loss_match_reference(arch, dtype, monkeypatch):
    jm, params, tm = models(arch, dtype)
    toks = _tokens(arch)
    labels = np.roll(toks, -1, axis=1)
    with force_reference_routing(arch, dtype, monkeypatch), \
            torch.no_grad():
        want_x = jm.forward(params, {"tokens": jnp.asarray(toks)})
        got_x = tm(torch.from_numpy(toks))
        want_l = jm.loss(params, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
        got_l = tm.loss({"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(labels)})
    assert got_x.dtype == (torch.float32 if dtype == "float32"
                           else torch.bfloat16)
    if dtype == "float32":
        close_f32(_np(got_x), _np(want_x))
        close_f32(float(got_l), float(want_l))
    else:
        assert rel_err(_np(got_x), _np(want_x)) < BF16_REL
        assert abs(float(got_l) - float(want_l)) <= \
            LOSS_RTOL * abs(float(want_l))


@pytest.mark.parametrize("arch", ["gemma2-9b", "paper-350m"])
def test_loss_gradients_flow_through_every_leaf(arch):
    """Remat per layer keeps every leaf's gradient (gemma2: both slots,
    qk / post norms included) finite and, for the weights, nonzero."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    cfg = SMOKE_ARCHS[arch]
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, B, "train"))
    tm = tbuild(cfg, run, device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(arch, n=32))
    loss = tm.loss({"tokens": toks, "labels": toks.roll(-1, 1)})
    leaves = T.leaves_with_path(tm.param_tree())
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    for (path, _), g in zip(leaves, grads):
        assert torch.isfinite(g).all(), path
        if path[-1].startswith("w") or path[-1] == "embed":
            assert g.abs().max() > 0, path


# ---------------------------------------------------------------------------
# the frontend stubs: seamless-m4t-medium's frames, llava's patches
# ---------------------------------------------------------------------------


def frontend_inputs(arch, n_tok, seed=2, batch=B):
    """Seeded non-zero float inputs of ``arch``'s stub for ``batch``
    sequences of ``n_tok`` tokens, {name: f32 numpy}, drawn as the
    pipeline draws them (N(0, 0.02^2)): zero frames would make the
    encoder's output exactly 0."""
    tm = tbuild(SMOKE_ARCHS[arch], device="meta")
    r = np.random.RandomState(seed)
    return {k: (r.randn(*d) * 0.02).astype(np.float32)
            for k, d in tm.frontend_shapes(batch, n_tok).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_forward_and_loss_match_reference(arch, dtype):
    """forward and loss with seeded non-zero frames / patch embeddings,
    from the reference's weights; the VLM's hidden states cover its
    patches and tokens."""
    jm, params, tm = models(arch, dtype)
    toks = _tokens(arch, n=40)
    extra = frontend_inputs(arch, 40)
    n = tm.n_prefix + 40
    labels = np.random.RandomState(4).randint(0, 256, size=(B, n)) \
        .astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    with torch.no_grad():
        got_x = tm(tb["tokens"], **{k: tb[k] for k in extra})
        got_l = tm.loss(tb)
    want_x, want_l = jm.forward(params, jb), jm.loss(params, jb)
    assert tuple(got_x.shape) == (B, n, tm.cfg.d_model)
    if dtype == "float32":
        close_f32(_np(got_x), _np(want_x))
        close_f32(float(got_l), float(want_l))
    else:
        assert rel_err(_np(got_x), _np(want_x)) < BF16_REL
        assert abs(float(got_l) - float(want_l)) <= \
            LOSS_RTOL * abs(float(want_l))


def test_zero_frames_give_an_encoder_output_of_exactly_zero():
    """With the frames the serving stub feeds (zeros) the encoder's output
    is exactly 0 (rms_norm(0) = 0 and no projection has a bias), in both
    packages, so its cross K/V are 0 too: a check of the encoder or the
    cross path must feed non-zero frames.  Non-zero frames give a
    non-zero output."""
    jm, params, tm = models("seamless-m4t-medium", "float32")
    zero = np.zeros((B, 64, tm.cfg.d_model), np.float32)
    with torch.no_grad():
        mem = tm.encode(torch.from_numpy(zero))
        _, caches = tm.prefill(torch.from_numpy(_tokens(
            "seamless-m4t-medium", n=16)), frames=torch.from_numpy(zero))
    assert not mem.abs().max()
    assert not np.abs(np.asarray(jm.encode(params, jnp.asarray(zero)))).max()
    assert not any(c.abs().max() for c in caches["cross"].values())
    seeded = frontend_inputs("seamless-m4t-medium", 16)["frames"]
    with torch.no_grad():
        mem = tm.encode(torch.from_numpy(seeded))
    close_f32(_np(mem), _np(jm.encode(params, jnp.asarray(seeded))))
    assert float(mem.abs().min(-1).values.min()) > 0


def test_vlm_loss_scores_the_patch_positions():
    """R9, kept: the reference's VLM loss scores its n_patches positions
    against the pipeline's left-padded label 0 (``mask=None``).  The
    port's loss is the reference's on the pipeline's batch, equals the
    mean cross-entropy over every position (the patches' label 0
    included), and moves when only the patches' labels change."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    arch = "llava-next-mistral-7b"
    jm, params, tm = models(arch, "float32")
    P = tm.cfg.n_patches
    b = TokenPipeline(tm, ShapeConfig("t", 32, B, "train"), seed=0) \
        .host_batch(0)
    assert b["tokens"].shape == (B, 32 - P) and b["labels"].shape == (B, 32)
    assert not b["labels"][:, :P].any()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        got = float(tm.loss(tb))
        logits = tm.logits(tm(tb["tokens"], patch_embs=tb["patch_embs"]))
        nll = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            tb["labels"].long().reshape(-1), reduction="none").reshape(B, 32)
    close_f32(got, float(jm.loss(params, {k: jnp.asarray(v)
                                          for k, v in b.items()})))
    close_f32(got, float(nll.mean()))
    tb["labels"][:, :P] = 7
    with torch.no_grad():
        moved = float(tm.loss(tb))
    close_f32(moved - got, float(
        (torch.logsumexp(logits[:, :P].float(), -1) - logits[:, :P, 7].float()
         - nll[:, :P]).sum() / (B * 32)), rtol=1e-3)
    assert moved != got
