"""Parity of the port's decode-accumulate folds (the plain versions of
K5-K11 in ``repro_torch/kernels/ref.py``, which the CPU wrappers of
``repro_torch/kernels/ops.py`` run) with the reference: its jitted
oracles (``repro/kernels/ref.py``) and its Pallas kernels
(``repro/kernels/decode.py``, interpreted on the CPU), on the same seeded
numpy inputs — rows with denormals, zeros and signed zeros, omega 0, a
saturating fixed-point width, and top-k at every k of the ladder.

Tolerance: none.  Every output is compared bit for bit (f32 as int32 bit
patterns).  One exception is stated where it applies: the interpreted
top-k kernel adds ``0 * term`` to every lane it does not touch, so it
turns a -0 or a denormal there into +0; the oracle's scatter-add (and the
port) leave such lanes as they were, so the interpreted kernel is held to
the port on rows whose untouched lanes hold neither.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode as jdec
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

ROWS = 16
KS = (256, 104, 16)
#: (fixed_bits, value scale): the default width, and one where
#: w * q * s * 2^bits passes 2^31 and the clip saturates
FP_CASES = ((16, 1.0), (30, 50.0))
WEIGHTS = (0.37, 0.0, 1.0)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)),
                                  err_msg=msg)


def _case(seed, scale=1.0, signed_zeros=True):
    """acc (ROWS, 1024) f32, q int8, nibbles, sign bits, s (ROWS, 1)."""
    r = np.random.RandomState(seed)
    acc = (r.randn(ROWS, 1024) * np.exp(r.randn(ROWS, 1))).astype(np.float32)
    acc[1] = 0.0
    acc[2, ::3] *= np.float32(1e-41)                 # denormals
    if signed_zeros:
        acc[3, ::5] = np.float32(-0.0)
    q = r.randint(-127, 128, size=(ROWS, 1024)).astype(np.int8)
    q[4] = 0
    nib = r.randint(0, 256, size=(ROWS, 512)).astype(np.uint8)
    sgn = r.randint(0, 256, size=(ROWS, 128)).astype(np.uint8)
    s = (np.abs(r.randn(ROWS, 1)) * 0.01 * scale).astype(np.float32)
    s[5] = 0.0
    s[6] = np.float32(3e-39)                         # a denormal scale
    s[7] = np.float32(1e-37)     # q * s normal, w * q * s may underflow
    return acc, q, nib, sgn, s


def _t(x):
    return torch.from_numpy(np.array(x))


def _w(w):
    return np.float32(w), torch.tensor(w, dtype=torch.float32)


@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_dequant_accum_f32(kind, w):
    """K5 / K6: acc + w * (q * s), one fused multiply-add."""
    acc, q, nib, _, s = _case(1)
    wj, wt = _w(w)
    src = q if kind == "int8" else nib
    jfn = (jref.dequant_accum_int8_ref if kind == "int8"
           else jref.dequant_accum_int4_ref)
    kfn = (jdec.dequant_accum_int8_fused if kind == "int8"
           else jdec.dequant_accum_int4_fused)
    pfn = (ref.dequant_accum_int8_ref if kind == "int8"
           else ref.dequant_accum_int4_ref)
    got = pfn(_t(acc), _t(src), _t(s), wt)
    _eq(got, jax.jit(jfn)(acc, src, s, wj), "oracle")
    _eq(got, kfn(acc, src, s, jnp.full((1, 1), wj), interpret=True),
        "interpret")


@pytest.mark.parametrize("bits,scale", FP_CASES)
@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_dequant_accum_fixed_point(kind, w, bits, scale):
    """K9 / K10: acc_i32 + fixed_point(w * q * s), wrapping int32 adds."""
    _, q, nib, _, s = _case(2, scale)
    r = np.random.RandomState(3)
    acc = r.randint(-2 ** 31, 2 ** 31, size=(ROWS, 1024)).astype(np.int32)
    wj, wt = _w(w)
    src = q if kind == "int8" else nib
    jfn = (jref.dequant_accum_int8_fp_ref if kind == "int8"
           else jref.dequant_accum_int4_fp_ref)
    kfn = (jdec.dequant_accum_int8_fp_fused if kind == "int8"
           else jdec.dequant_accum_int4_fp_fused)
    pfn = (ref.dequant_accum_int8_fp_ref if kind == "int8"
           else ref.dequant_accum_int4_fp_ref)
    got = pfn(_t(acc), _t(src), _t(s), wt, bits)
    _eq(got, jax.jit(jfn, static_argnums=4)(acc, src, s, wj, bits),
        "oracle")
    _eq(got, kfn(acc, src, s, jnp.full((1, 1), wj), bits=bits,
                 interpret=True), "interpret")
    if scale > 1.0 and w:
        sat = ref.fixed_point(torch.tensor([1e30]), bits)
        assert int(sat) == int(ref.INT32_SAT)


@pytest.mark.parametrize("w", WEIGHTS)
def test_sign_vote_accum_f32(w):
    """K7: vote + w * (+-1 from the bit-packed signs), mag + w * s."""
    acc, _, _, sgn, s = _case(4)
    mag = np.random.RandomState(5).randn(ROWS, 1).astype(np.float32)
    mag[0] = np.float32(-0.0)
    mag[1] = np.float32(2e-40)
    wj, wt = _w(w)
    gv, gm = ref.sign_vote_accum_ref(_t(acc), _t(mag), _t(sgn), _t(s), wt)
    ov, om = jax.jit(jref.sign_vote_accum_ref)(acc, mag, sgn, s, wj)
    _eq(gv, ov, "oracle vote")
    _eq(gm, om, "oracle mag")
    kv, km = jdec.sign_vote_accum_fused(acc, mag, sgn, s,
                                        jnp.full((1, 1), wj),
                                        interpret=True)
    _eq(gv, kv, "interpret vote")
    _eq(gm, km, "interpret mag")


@pytest.mark.parametrize("bits,scale", FP_CASES)
@pytest.mark.parametrize("w", WEIGHTS)
def test_sign_vote_accum_fixed_point(w, bits, scale):
    """K11: integer votes + fixed_point(w) * (+-1), mag + fixed_point(w*s)."""
    _, _, _, sgn, s = _case(6, scale * 1e4)
    r = np.random.RandomState(7)
    vote = r.randint(-2 ** 31, 2 ** 31, size=(ROWS, 1024)).astype(np.int32)
    mag = r.randint(-2 ** 31, 2 ** 31, size=(ROWS, 1)).astype(np.int32)
    wj, wt = _w(w)
    gv, gm = ref.sign_vote_accum_fp_ref(_t(vote), _t(mag), _t(sgn), _t(s),
                                        wt, bits)
    ov, om = jax.jit(jref.sign_vote_accum_fp_ref, static_argnums=5)(
        vote, mag, sgn, s, wj, bits)
    _eq(gv, ov, "oracle vote")
    _eq(gm, om, "oracle mag")
    kv, km = jdec.sign_vote_accum_fp_fused(vote, mag, sgn, s,
                                           jnp.full((1, 1), wj), bits=bits,
                                           interpret=True)
    _eq(gv, kv, "interpret vote")
    _eq(gm, km, "interpret mag")


def _topk_case(seed, k, signed_zeros):
    acc, _, _, _, s = _case(seed, signed_zeros=signed_zeros)
    r = np.random.RandomState(seed + 100)
    q = r.randint(-127, 128, size=(ROWS, k)).astype(np.int8)
    idx = np.stack([r.permutation(1024)[:k]
                    for _ in range(ROWS)]).astype(np.uint16)
    return acc, q, idx, s


@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("k", KS)
def test_topk_scatter_accum(k, w):
    """K8: acc with w * (q * s) added at the kept lanes (no FMA); the
    other lanes keep their bits, -0 and denormals included."""
    wj, wt = _w(w)
    acc, q, idx, s = _topk_case(8, k, signed_zeros=True)
    got = ref.topk_scatter_accum_ref(_t(acc), _t(q), _t(idx), _t(s), wt)
    _eq(got, jax.jit(jref.topk_scatter_accum_ref)(acc, q, idx, s, wj),
        "oracle")
    # the interpreted kernel rewrites untouched -0 / denormal lanes as +0
    acc, q, idx, s = _topk_case(9, k, signed_zeros=False)
    acc[2] = np.abs(acc[2]) + 1.0
    got = ref.topk_scatter_accum_ref(_t(acc), _t(q), _t(idx), _t(s), wt)
    _eq(got, jdec.topk_scatter_accum_fused(acc, q, idx, s,
                                           jnp.full((1, 1), wj),
                                           interpret=True), "interpret")


def test_fixed_point_round_trip():
    """fixed_point rounds half to even and saturates; from_fixed_point is
    its inverse on the grid — against the reference's own functions."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 1e-41, -1e-41, 3e9, -3e9,
                  1.0 / 3, -7.25e-6], np.float32) * np.float32(2.0 ** -16)
    x = np.concatenate([x, np.array([3e9, -3e9, 0.0, -0.0], np.float32)])
    for bits in (0, 16, 24):
        got = ref.fixed_point(_t(x), bits)
        _eq(got, jdec.fixed_point(jnp.asarray(x), bits), f"bits {bits}")
        _eq(ref.from_fixed_point(got, bits),
            jdec.from_fixed_point(jnp.asarray(got.numpy()), bits))


def test_unpack_signs_matches_reference():
    p = np.random.RandomState(10).randint(0, 256, size=(3, 128)) \
        .astype(np.uint8)
    _eq(ref.unpack_signs(_t(p)), jdec.unpack_signs(jnp.asarray(p)))


@pytest.mark.parametrize("name,fixed", [
    (n, f) for n in ("int8", "int4", "sign", "topk") for f in (None, 16)
    if not (n == "topk" and f)])          # top-k folds in float only
def test_cpu_wrappers_take_the_plain_versions(name, fixed):
    """The ops wrappers on CPU tensors return the plain versions' values
    and launch nothing; their shapes follow repro/kernels/ops.py (scales
    (nb,), mag (nb,))."""
    acc, q, nib, sgn, s = _case(11)
    w = torch.tensor(0.25)
    ops.reset_launch_counts()
    s1 = _t(s[:, 0])
    if name == "sign":
        mag = torch.zeros(ROWS, dtype=torch.int32 if fixed else
                          torch.float32)
        vote = torch.zeros(ROWS, 1024, dtype=mag.dtype)
        got = ops.sign_vote_accum(vote, mag, _t(sgn), s1, w,
                                  fixed_bits=fixed)
        want = (ref.sign_vote_accum_fp_ref(vote, mag[:, None], _t(sgn),
                                           _t(s), w, fixed) if fixed else
                ref.sign_vote_accum_ref(vote, mag[:, None], _t(sgn), _t(s),
                                        w))
        _eq(got[0], want[0])
        _eq(got[1], want[1].reshape(-1))
    elif name == "topk":
        a, qk, idx, sk = _topk_case(12, 104, True)
        got = ops.topk_scatter_accum(_t(a), _t(qk), _t(idx),
                                     _t(sk[:, 0]), w)
        _eq(got, ref.topk_scatter_accum_ref(_t(a), _t(qk), _t(idx),
                                            _t(sk), w))
    else:
        src = q if name == "int8" else nib
        fn = ops.decode_accum_int8 if name == "int8" \
            else ops.decode_accum_int4
        a = torch.zeros(ROWS, 1024, dtype=torch.int32) if fixed \
            else _t(acc)
        got = fn(a, _t(src), s1, w, fixed_bits=fixed)
        if fixed:
            pf = (ref.dequant_accum_int8_fp_ref if name == "int8"
                  else ref.dequant_accum_int4_fp_ref)
            want = pf(a, _t(src), _t(s), w, fixed)
        else:
            pf = (ref.dequant_accum_int8_ref if name == "int8"
                  else ref.dequant_accum_int4_ref)
            want = pf(a, _t(src), _t(s), w)
        _eq(got, want)
    assert all(n == 0 for n in ops.launch_counts().values())


# ---- the one-shot fold of gathered wires ----------------------------------

FOLD_CODECS = [("int8", {}), ("int4", {}), ("sign", {}),
               ("topk", {"ratio": 0.25}), ("topk", {"ratio": 0.1}),
               ("topk", {"ratio": 0.01})]
FOLD_NB = 3


def _gathered(name, kw, n_pods):
    """P payloads of the reference codec (distinct grads per pod), packed
    by both packages -> (reference stacked wire, port stacked wire, the
    two metas, omega)."""
    from repro.codecs import build_codec as jbuild
    from repro.codecs import pack_payload as jpack
    from repro_torch.codecs import pack_payload as tpack
    jc = jbuild(name, **kw)
    n = FOLD_NB * 1024
    jwires, twires = [], []
    for p in range(n_pods):
        r = np.random.RandomState(40 + p)
        g = (r.randn(n) * np.exp(r.randn())).astype(np.float32)
        e = (r.randn(n) * 0.1).astype(np.float32)
        pay, _, _ = jc.ef_encode(jnp.asarray(g), jnp.asarray(e), gamma=0.8)
        jw, jmeta = jpack(pay)
        tw, tmeta = tpack({k: _t(np.asarray(v)) for k, v in pay.items()})
        _eq(tw, np.asarray(jw), "packed wire")
        jwires.append(np.asarray(jw))
        twires.append(tw)
    omega = np.arange(1, n_pods + 1, dtype=np.float32)
    omega /= omega.sum()
    return (np.stack(jwires), torch.stack(twires), jmeta, tmeta, omega, n)


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("n_pods", [2, 3, 4])
@pytest.mark.parametrize("name,kw", FOLD_CODECS,
                         ids=[f"{n}{kw.get('ratio', '')}"
                              for n, kw in FOLD_CODECS])
def test_wire_decode_fold_matches_reference(name, kw, n_pods, det):
    """The gathered (P, payload) wires folded in pod order — float, or
    fixed point (top-k: canonical-order float) — equal the reference's
    fold through its decode-accumulate kernels (interpreted), bit for
    bit."""
    from repro.codecs import build_codec as jbuild
    from repro_torch.codecs import build_codec as tbuild
    jg, tg, jmeta, tmeta, omega, n = _gathered(name, kw, n_pods)
    jc, tc = jbuild(name, **kw), tbuild(name, **kw)
    want = jax.jit(lambda g, om: jc.wire_decode_fold(
        g, jmeta, om, n=n, use_pallas=True, deterministic=det,
        fixed_bits=16))(jnp.asarray(jg), jnp.asarray(omega))
    got = tc.wire_decode_fold(tg, tmeta, _t(omega), n=n, deterministic=det,
                              fixed_bits=16)
    _eq(got, want)
