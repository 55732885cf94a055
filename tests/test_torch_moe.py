"""Parity of the port's MoE FFN (``repro_torch.models.moe``) with the
reference's ``repro.models.moe`` on the CPU, on seeded numpy inputs at
the two MoE SMOKE configs' widths (qwen3-moe: 8 experts top-2, D 64,
Fe 32; dbrx: 4 experts top-2, D 64, Fe 96).

* ``capacity``: equal to the reference's, exactly.
* Dispatch against ``_dispatch_local``: the experts ``eidx``, each
  pair's row ``pos_c`` (hence the keep mask) and the buffer ``ebuf``
  exactly; ``gate_keep`` in f32 within 1e-6 relative, and in bf16 equal
  but where the f32 gate lies within 1e-6 relative of a bf16 rounding
  midpoint (the two softmaxes may differ in the last f32 bit, and round
  to the neighbouring bf16 value there).  Cases: random logits, logits
  with exact ties (the lower expert index first, as ``jax.lax.top_k``),
  capacity factor 0.5 (many pairs dropped: the same ones), and a batch
  whose rows start with left-pad tokens (identical rows that take
  capacity like any other).
* ``expert_ffn`` and ``combine``: f32 within 1e-5 relative; bf16 within
  ``BF16_OP_REL`` = 1e-2 in relative norm (2.5 bf16 ulps: the two
  frameworks round the matmuls' and the products' outputs at other
  points).
* ``moe_apply``: f32 within ``F32_RTOL`` = 1e-4, bf16 within
  ``BF16_REL`` = 3e-2 in relative norm (tests/test_torch_models.py's).
* ``load_balance_loss``: within 1e-6.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models import moe as JM
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.models import moe as TM
from test_torch_models import BF16_REL, F32_RTOL, MOE, close_f32, rel_err

BF16_OP_REL = 1e-2
T_TOKENS = 96


def cfgs(arch, **kw):
    return (dataclasses.replace(SMOKE_ARCHS[arch], **kw),
            dataclasses.replace(J_SMOKE[arch], **kw))


def bf16(a):
    """``a`` rounded to bf16, as a float32 numpy array."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def to_torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_reference(arch):
    for cf in (0.5, 1.0, 1.25, 2.0, 16.0):
        cfg, jcfg = cfgs(arch, capacity_factor=cf)
        full = dataclasses.replace(ARCHS[arch], capacity_factor=cf)
        for T in (1, 2, 4, 7, 8, 31, 64, 128, 500, 512, 528, 2048, 4099):
            assert TM.capacity(T, cfg) == JM.capacity(T, jcfg), (cf, T)
            assert TM.capacity(T, full) == JM.capacity(T, full), (cf, T)
    # serving's workload (a): prefill T = 4 x 512, decode T = 4
    assert TM.capacity(2048, ARCHS["qwen3-moe-30b-a3b"]) == 160
    assert TM.capacity(4, ARCHS["qwen3-moe-30b-a3b"]) == 8
    assert TM.capacity(2048, ARCHS["dbrx-132b"]) == 640


def test_route_breaks_ties_to_the_lower_expert():
    logits = torch.tensor([[1.0, 2.0, 2.0, 0.5, 2.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0],
                           [3.0, 1.0, 3.0, 1.0, 1.0]])
    _, eidx = TM.route(logits, 3)
    assert eidx.tolist() == [[1, 2, 4], [0, 1, 2], [0, 2, 1]]
    _, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert eidx.tolist() == np.asarray(jidx).tolist()


def _dispatch_case(arch, case, seed=0):
    """(cfg, jcfg, xf (T, D) f32, logits (T, E) f32) for ``case``."""
    cf = 0.5 if case == "cf0.5" else 1.25
    cfg, jcfg = cfgs(arch, capacity_factor=cf)
    r = np.random.RandomState(seed)
    D, E = cfg.d_model, cfg.n_experts
    router = (r.randn(D, E) * 0.02).astype(np.float32)
    if case == "pad":
        # 2 sequences of 48, left-padded: the first 40 / 30 rows are the
        # pad token's (equal) embedding, more than the capacity of the
        # experts they all route to
        x = r.randn(2, 48, D).astype(np.float32)
        pad = r.randn(D).astype(np.float32)
        x[0, :40] = pad
        x[1, :30] = pad
        xf = x.reshape(-1, D)
    else:
        xf = r.randn(T_TOKENS, D).astype(np.float32)
    logits = xf @ router
    if case == "ties":
        # few distinct values per row: exact ties at and around the k-th
        logits = np.round(logits * 8).astype(np.float32) / 8
        logits[::5] = 0.0
    return cfg, jcfg, xf, logits.astype(np.float32)


CASES = ["random", "ties", "cf0.5", "pad"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_matches_reference(arch, case, dtype):
    cfg, jcfg, xf, logits = _dispatch_case(arch, case)
    T = xf.shape[0]
    C = TM.capacity(T, cfg)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    if dtype == "bfloat16":
        xf = bf16(xf)
    jb, je, jp, jg = JM._dispatch_local(jnp.asarray(xf, jdt),
                                        jnp.asarray(logits), jcfg, C)
    tb, te, tp, tg = TM.dispatch(to_torch(xf, tdt), to_torch(logits,
                                                             torch.float32),
                                 cfg, C)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tb.dtype == tdt and tuple(tb.shape) == tuple(jb.shape)
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))
    dropped = int((tp.numpy() == C).sum())
    if case == "cf0.5":
        assert dropped > T * cfg.experts_per_token // 4
    if case == "pad":
        assert dropped > 0
    got, want = tg.float().numpy(), np.asarray(jg.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        # the f32 gates of both packages, and where the bf16 ones differ,
        # the reference's f32 gate sits at a rounding midpoint
        g32 = np.asarray(JM._dispatch_local(
            jnp.asarray(xf), jnp.asarray(logits), jcfg, C)[3])
        lo, hi = np.minimum(got, want), np.maximum(got, want)
        ulp = np.asarray(jnp.asarray(np.maximum(np.abs(lo), 1e-30),
                                     jnp.bfloat16).astype(jnp.float32))
        ulp = ulp * 2.0 ** -7
        diff = got != want
        assert np.all(hi[diff] - lo[diff] <= ulp[diff] * 1.0001)
        mid = (lo + hi) / 2
        assert np.all(np.abs(g32[diff] - mid[diff]) <= 1e-6 * mid[diff])


def _ffn_weights(cfg, seed):
    r = np.random.RandomState(seed)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {"router": (r.randn(D, E) * 0.02).astype(np.float32),
            "w_gate": (r.randn(E, D, Fe) / np.sqrt(D)).astype(np.float32),
            "w_up": (r.randn(E, D, Fe) / np.sqrt(D)).astype(np.float32),
            "w_down": (r.randn(E, Fe, D) / np.sqrt(Fe)).astype(np.float32)}


def _check(got, want, dtype, f32_rtol, bf16_rel):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        close_f32(got, want, f32_rtol)
    else:
        assert rel_err(got, want) < bf16_rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_expert_ffn_and_combine_match_reference(arch, dtype):
    cfg, jcfg = cfgs(arch)
    w = _ffn_weights(cfg, 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    r = np.random.RandomState(2)
    C = 16
    ebuf = r.randn(cfg.n_experts, C, cfg.d_model).astype(np.float32)
    if dtype == "bfloat16":
        ebuf = bf16(ebuf)
    ws = ("w_gate", "w_up", "w_down")
    want = JM._expert_ffn(jnp.asarray(ebuf, jdt),
                          *(jnp.asarray(w[k]) for k in ws))
    got = TM.expert_ffn(to_torch(ebuf, tdt),
                        *(torch.from_numpy(w[k]) for k in ws))
    assert got.dtype == tdt
    _check(got, want, dtype, 1e-5, BF16_OP_REL)

    # combine over the same rows: pairs of 40 tokens, some dropped (C)
    T, K = 40, cfg.experts_per_token
    eidx = np.stack([r.choice(cfg.n_experts, K, replace=False)
                     for _ in range(T)]).astype(np.int32)
    pos = r.randint(0, C + 1, size=(T, K)).astype(np.int32)
    gates = r.rand(T, K).astype(np.float32) * (pos < C)
    out = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        gates = bf16(gates)
    want = JM._combine_local(jnp.asarray(out, jdt), jnp.asarray(eidx),
                             jnp.asarray(pos), jnp.asarray(gates, jdt))
    got = TM.combine(to_torch(out, tdt), torch.from_numpy(eidx).long(),
                     torch.from_numpy(pos).long(), to_torch(gates, tdt))
    assert got.dtype == tdt
    _check(got, want, dtype, 1e-5, BF16_OP_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch, cf, dtype):
    cfg, jcfg = cfgs(arch, capacity_factor=cf)
    w = _ffn_weights(cfg, 3)
    x = np.random.RandomState(4).randn(2, 48, cfg.d_model) \
        .astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    if dtype == "bfloat16":
        x = bf16(x)
    want = JM.moe_apply({k: jnp.asarray(v) for k, v in w.items()},
                        jnp.asarray(x, jdt), jcfg)
    got = TM.moe_apply({k: torch.from_numpy(v) for k, v in w.items()},
                       to_torch(x, tdt), cfg)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    _check(got, want, dtype, F32_RTOL, BF16_REL)


@pytest.mark.parametrize("arch", MOE)
def test_load_balance_loss_matches_reference(arch):
    cfg, jcfg = cfgs(arch)
    r = np.random.RandomState(5)
    logits = r.randn(T_TOKENS, cfg.n_experts).astype(np.float32)
    eidx = np.asarray(jax.lax.top_k(jnp.asarray(logits),
                                    cfg.experts_per_token)[1])
    want = float(JM.load_balance_loss(jnp.asarray(logits),
                                      jnp.asarray(eidx), jcfg))
    got = float(TM.load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(np.array(eidx)).long(),
                                     cfg))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_executed_flops_count_every_expert_at_capacity():
    """``flops.executed_flops``: the dense part at 2 * N per token, plus
    every expert over its C rows; serving's workload (a) on qwen3-moe
    (T = 2,048, C = 160) executes 9.28e12 FLOPs in the experts against
    7.42e12 of active expert work (1.25x); a train step 3x its
    forward's; a dense model's equal ``model_flops``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import flops
    cfg = ARCHS["qwen3-moe-30b-a3b"]
    shape = ShapeConfig("a", 512, 4, "prefill")
    expert = 3 * cfg.d_model * cfg.d_ff
    active_experts = 2.0 * 2048 * cfg.experts_per_token * expert \
        * cfg.n_layers
    executed = flops.executed_flops(cfg, shape)
    active = flops.model_flops(cfg, shape)
    assert executed - active == pytest.approx(9.277e12 - active_experts,
                                              rel=1e-3)
    assert round(active_experts / 1e10) == 742
    assert executed - (active - active_experts) == \
        2.0 * expert * cfg.n_experts * 160 * cfg.n_layers
    decode = ShapeConfig("d", 1, 4, "decode")
    assert flops.executed_flops(cfg, decode) - flops.model_flops(
        cfg, decode) == 2.0 * expert * cfg.n_layers * (
            cfg.n_experts * 8 - 4 * cfg.experts_per_token)
    dense = SMOKE_ARCHS["qwen3-8b"]
    assert flops.executed_flops(dense, shape) == flops.model_flops(dense,
                                                                   shape)
    # a train step executes 3x its forward: the backward twice the
    # forward, as 6 * N * D counts it against 2 * N * D
    train = ShapeConfig("t", 512, 4, "train")
    assert flops.executed_flops(cfg, train) == 3.0 * executed
    assert flops.model_flops(cfg, train) == 3.0 * active
    assert flops.executed_flops(dense, train) == flops.model_flops(dense,
                                                                   train)


# ---------------------------------------------------------------------------
# gradients through the capacity dispatch
# ---------------------------------------------------------------------------


def _grad_rel(got, want):
    """max |got - want| relative to want's largest magnitude."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", MOE)
def test_moe_gradients_match_reference_with_drops(arch):
    """At capacity factor 0.25 most (token, k) pairs drop.  The f32
    gradients of ``moe_apply`` into x, the router (through the top-k:
    ``jax.lax.top_k``'s gradient in the reference) and the expert stacks
    equal ``jax.grad``'s within 1e-5 of each leaf's largest magnitude, and
    a token whose every pair was dropped gets exactly zero gradient into
    x (and so, through its router logits, into the router)."""
    cfg, jcfg = cfgs(arch, capacity_factor=0.25)
    w = _ffn_weights(cfg, 6)
    r = np.random.RandomState(7)
    x = r.randn(2, 48, cfg.d_model).astype(np.float32)
    cot = r.randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JM.moe_apply(p, xx, jcfg) * cot)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (TM.moe_apply(tw, tx, cfg) * torch.from_numpy(cot)).sum().backward()
    assert _grad_rel(tx.grad, jgx) <= 1e-5
    for k in w:
        assert _grad_rel(tw[k].grad, jgp[k]) <= 1e-5, k
    # the tokens whose every pair was dropped
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    T = xf.shape[0]
    C = TM.capacity(T, cfg)
    _, _, pos_c, _ = TM.dispatch(xf, xf @ torch.from_numpy(w["router"]),
                                 cfg, C)
    gone = (pos_c == C).all(dim=1)
    assert 0 < int(gone.sum()) < T
    assert torch.all(tx.grad.reshape(T, -1)[gone] == 0)
    assert torch.all(tx.grad.reshape(T, -1)[~gone].abs().amax(1) > 0)


@pytest.mark.parametrize("arch", MOE)
def test_router_gradient_flows_through_the_kept_logits(arch):
    """The gradient of the dispatch's outputs (the buffer and the kept
    gates) into the router logits equals ``jax.grad``'s through
    ``jax.lax.top_k`` (f32, within 1e-6 relative); it is exactly zero
    outside each row's top k and on every row whose pairs all dropped;
    an all-ties row routes to the lowest k experts."""
    cfg, jcfg = cfgs(arch, capacity_factor=0.5)
    _, _, xf, logits = _dispatch_case(arch, "random", seed=8)
    logits[::7] = 0.25                                 # all-ties rows
    T, K = xf.shape[0], cfg.experts_per_token
    C = TM.capacity(T, cfg)
    r = np.random.RandomState(9)
    rb = r.randn(cfg.n_experts, C, cfg.d_model).astype(np.float32)
    rg = r.randn(T, K).astype(np.float32)

    def jloss(lg):
        ebuf, _, _, gk = JM._dispatch_local(jnp.asarray(xf), lg, jcfg, C)
        return jnp.sum(ebuf * rb) + jnp.sum(gk * rg)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    ebuf, eidx, pos_c, gk = TM.dispatch(torch.from_numpy(xf), lg, cfg, C)
    ((ebuf * torch.from_numpy(rb)).sum()
     + (gk * torch.from_numpy(rg)).sum()).backward()
    got = lg.grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    top = torch.zeros_like(got, dtype=torch.bool).scatter_(1, eidx, True)
    assert torch.all(got[~top] == 0)
    gone = (pos_c == C).all(dim=1)
    assert int(gone.sum()) > 0 and torch.all(got[gone] == 0)
    assert eidx[::7].tolist() == [list(range(K))] * len(eidx[::7])


@pytest.mark.parametrize("arch", MOE)
def test_combine_backward_is_an_indexed_copy(arch):
    """``combine``'s backward copies each kept pair's gradient to its
    (expert, row) and nothing else: equal to autograd's accumulating
    backward of the plain gather, to ``jax.grad`` of the reference's
    ``_combine_local`` (f32, 1e-6 relative), and exactly zero on every row
    no kept pair reads."""
    cfg, jcfg = cfgs(arch, capacity_factor=0.5)
    _, _, xf, logits = _dispatch_case(arch, "random", seed=10)
    T, K = xf.shape[0], cfg.experts_per_token
    C = TM.capacity(T, cfg)
    _, eidx, pos_c, gk = TM.dispatch(torch.from_numpy(xf),
                                     torch.from_numpy(logits), cfg, C)
    assert int((pos_c == C).sum()) > 0
    r = np.random.RandomState(11)
    out = torch.from_numpy(
        r.randn(cfg.n_experts, C, cfg.d_model).astype(np.float32))
    cot = torch.from_numpy(r.randn(T, cfg.d_model).astype(np.float32))
    o1 = out.clone().requires_grad_()
    (TM.combine(o1, eidx, pos_c, gk) * cot).sum().backward()
    o2 = out.clone().requires_grad_()
    plain = (o2[eidx, pos_c.clamp(max=C - 1)] * gk[..., None]).sum(1)
    (plain * cot).sum().backward()
    assert torch.equal(o1.grad, o2.grad)
    want = np.asarray(jax.grad(lambda o: jnp.sum(JM._combine_local(
        o, jnp.asarray(eidx.numpy()), jnp.asarray(pos_c.numpy()),
        jnp.asarray(gk.numpy())) * cot.numpy()))(jnp.asarray(out.numpy())))
    np.testing.assert_allclose(o1.grad.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    read = torch.zeros((cfg.n_experts, C + 1), dtype=torch.bool)
    read[eidx, pos_c] = True
    assert torch.all(o1.grad[~read[:, :C]] == 0)
