"""Parity of the port's flat encoders and int8 dequantiser (K12-K16, the
plain PyTorch versions that the CUDA kernels are held to bit for bit on
the card) against the reference's Pallas kernels in interpret mode
(``quantize_int8_fused``, ``ef_int4_fused``, ``ef_sign_fused``,
``ef_topk_select``, ``dequantize_int8``), and of each codec's flat
``ef_encode`` (the ring's encode: payload, own, new residual) against the
reference's jitted ``ef_encode(use_pallas=True)``.

Inputs are seeded numpy rows in multiples of the reference's 8-row tile,
with a denormal row, an all-zero row and -0 entries, at gamma 1.0 / 0.9 /
0.6 and every k of the ladder's top-k rungs.

Tolerances: bit for bit (int32 bit patterns, so the sign of zero counts),
except the sign rung's scale and what derives from it: XLA sums
``mean|ef|`` in another order than the port's fixed 4-lane-then-tree
order, so the scale may differ by 8 ulp and the residual and ``own`` by
8 ulp of the scale (tests/test_torch_kernels.py states the same bound
for the gather kernel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codecs import build_codec as jbuild
from repro.kernels.quantize import (dequantize_int8, ef_int4_fused,
                                    quantize_int8_fused)
from repro.kernels.sign import ef_sign_fused
from repro.kernels.topk_compress import ef_topk_select
from repro_torch.codecs import build_codec as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

LANES = 1024
GAMMAS = (1.0, 0.9, 0.6)
#: k of the 25 / 10 / 1 % top-k rungs of the ladder
TOPK_KS = (256, 104, 16)
SIGN_ULP = 8


def _rows(rows, seed):
    """(g, e) (rows, LANES) f32: row 0 denormal, row 1 zero, -0 entries
    in row 2, the rest on scales spanning ~1e-6..1e6."""
    r = np.random.RandomState(seed)
    mag = np.exp(r.uniform(-14, 14, size=(rows, 1)))
    g = (r.randn(rows, LANES) * mag).astype(np.float32)
    e = (r.randn(rows, LANES) * mag).astype(np.float32)
    g[0] *= np.float32(1e-41)
    e[0] *= np.float32(1e-41)
    g[1] = e[1] = 0.0
    g[2, ::3] = np.float32(-0.0)
    e[2, ::3] = np.float32(-0.0)
    return g, e


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


def _sign_close(scale_got, scale_want, *derived):
    """The sign rung's scale within SIGN_ULP ulp; each (got, want) pair of
    ``derived`` (rows, LANES) within SIGN_ULP ulp of the row's scale."""
    sw = np.asarray(scale_want).reshape(-1)
    ulp = np.abs(_bits(np.asarray(scale_got).reshape(-1)).astype(np.int64)
                 - _bits(sw).astype(np.int64))
    assert ulp.max() <= SIGN_ULP, ulp.max()
    tol = SIGN_ULP * np.spacing(np.abs(sw))[:, None] + 0.0
    for got, want in derived:
        got = np.asarray(got).reshape(len(sw), -1)
        want = np.asarray(want).reshape(len(sw), -1)
        assert np.all(np.abs(got - want) <= tol)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("rows", [8, 24])
@pytest.mark.parametrize("gamma", GAMMAS)
def test_quantize_int8_matches_reference(rows, gamma):
    """K12 on x that already carries the error feedback."""
    g, e = _rows(rows, rows)
    x = tref.ef_accumulate(_t(g), _t(e), gamma).numpy()
    want = quantize_int8_fused(jnp.asarray(x), interpret=True)
    got = tref.quantize_int8_ref(_t(x))
    for a, b in zip(got, want):
        _same(a.numpy(), b)


@pytest.mark.parametrize("rows", [8, 24])
@pytest.mark.parametrize("gamma", GAMMAS)
def test_ef_int4_matches_reference(rows, gamma):
    """K13."""
    g, e = _rows(rows, 10 + rows)
    want = ef_int4_fused(jnp.asarray(g), jnp.asarray(e), gamma=gamma,
                         interpret=True)
    got = tref.ef_int4_ref(_t(g), _t(e), gamma=gamma)
    for a, b in zip(got, want):
        _same(a.numpy(), b)


@pytest.mark.parametrize("rows", [8, 24])
@pytest.mark.parametrize("gamma", GAMMAS)
def test_ef_sign_matches_reference(rows, gamma):
    """K14: the signs bit for bit, scale and residual within the
    summation-order bound."""
    g, e = _rows(rows, 20 + rows)
    sg_w, s_w, r_w = ef_sign_fused(jnp.asarray(g), jnp.asarray(e),
                                   gamma=gamma, interpret=True)
    sg, s, r = tref.ef_sign_ref(_t(g), _t(e), gamma=gamma)
    _same(sg.numpy(), sg_w)
    _sign_close(s.numpy(), s_w, (r.numpy(), r_w))


@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("gamma", GAMMAS)
def test_ef_topk_select_matches_reference(k, gamma):
    """K15 at every k of the ladder."""
    g, e = _rows(16, 30 + k)
    want = ef_topk_select(jnp.asarray(g), jnp.asarray(e), gamma=gamma, k=k,
                          interpret=True)
    got = tref.ef_topk_select_ref(_t(g), _t(e), gamma=gamma, k=k)
    for a, b in zip(got, want):
        _same(a.numpy(), b)


def test_dequantize_int8_matches_reference():
    """K16, with a zero and a denormal scale."""
    g, _ = _rows(16, 40)
    q, s, _ = quantize_int8_fused(jnp.asarray(g), interpret=True)
    s = np.asarray(s).copy()
    s[3], s[4] = 0.0, np.float32(3e-39)
    want = dequantize_int8(q, jnp.asarray(s), interpret=True)
    got = tref.dequantize_int8_ref(_t(np.asarray(q)), _t(s))
    _same(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 1024 * 3, 1024 * 5 + 333])
def test_flat_wrappers_pad_and_slice(n):
    """The ops wrappers take flat (n,) buffers: ceil(n / LANES) rows, the
    tail row zero-padded, residual and selection sliced to n — the plain
    versions on the padded rows, and K16 undoes K12's layout."""
    r = np.random.RandomState(n)
    g = r.randn(n).astype(np.float32)
    e = r.randn(n).astype(np.float32)
    rows = -(-n // LANES)
    pad = np.zeros(rows * LANES - n, np.float32)
    g2 = _t(np.concatenate([g, pad]).reshape(rows, LANES))
    e2 = _t(np.concatenate([e, pad]).reshape(rows, LANES))
    q, s, res, n_ = tops.quantize_int8(_t(g))
    want = tref.quantize_int8_ref(g2)
    assert n_ == n and q.shape == (rows, LANES) and res.shape == (n,)
    _same(q.numpy(), want[0].numpy())
    _same(s.numpy(), want[1].numpy())
    _same(res.numpy(), want[2].reshape(-1)[:n].numpy())
    _same(tops.dequant_int8(q, s, n).numpy(),
          tref.dequantize_int8_ref(q, s).reshape(-1)[:n].numpy())
    for name, plain in (("ef_int4", tref.ef_int4_ref),
                        ("ef_sign", tref.ef_sign_ref)):
        p, s, res, n_ = getattr(tops, name)(_t(g), _t(e), gamma=0.9)
        want = plain(g2, e2, gamma=0.9)
        assert n_ == n
        _same(p.numpy(), want[0].numpy())
        _same(s.numpy(), want[1].numpy())
        _same(res.numpy(), want[2].reshape(-1)[:n].numpy())
    sel, res = tops.ef_topk(_t(g), _t(e), gamma=0.9, k=104)
    want = tref.ef_topk_select_ref(g2, e2, gamma=0.9, k=104)
    _same(sel.numpy(), want[0].reshape(-1)[:n].numpy())
    _same(res.numpy(), want[1].reshape(-1)[:n].numpy())


CODECS = [("int8", {}), ("int4", {}), ("sign", {}), ("topk", {"ratio": 0.25}),
          ("topk", {"ratio": 0.1}), ("topk", {"ratio": 0.01})]


@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("name,kw", CODECS,
                         ids=[f"{n}{kw.get('ratio', '')}" for n, kw in
                              CODECS])
def test_codec_flat_ef_encode_matches_reference(name, kw, gamma):
    """Each codec's flat ``ef_encode`` (the ring's encode) against the
    reference's jitted ``ef_encode(use_pallas=True)`` on a buffer that is
    no block multiple: payload, own and the new residual."""
    n = LANES * 6 + 517
    r = np.random.RandomState(len(name) + int(gamma * 10))
    g = (r.randn(n) * np.exp(r.uniform(-6, 6))).astype(np.float32)
    e = r.randn(n).astype(np.float32) * np.float32(0.3)
    g[:LANES] *= np.float32(1e-41)
    g[LANES:2 * LANES] = 0.0
    e[LANES:2 * LANES] = 0.0
    jc = jbuild(name, **kw)
    fn = jax.jit(lambda a, b: jc.ef_encode(a, b, gamma=gamma,
                                           use_pallas=True))
    pay_w, own_w, ne_w = fn(jnp.asarray(g), jnp.asarray(e))
    pay, own, ne = tbuild(name, **kw).ef_encode(_t(g), _t(e), gamma=gamma)
    assert sorted(pay) == sorted(pay_w)
    if name != "sign":
        for k in pay:
            _same(pay[k].numpy(), pay_w[k])
        _same(own.numpy(), own_w)
        _same(ne.numpy(), ne_w)
        return
    _same(pay["q"].numpy(), pay_w["q"])
    nb = pay["scale"].shape[0]
    pad = nb * LANES - n

    def rows(x):
        return np.concatenate([np.asarray(x), np.zeros(pad, np.float32)])

    _sign_close(pay["scale"].numpy(), pay_w["scale"],
                (rows(own.numpy()), rows(own_w)),
                (rows(ne.numpy()), rows(ne_w)))
