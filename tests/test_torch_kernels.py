"""Parity of the port's gather + EF encode kernels (their plain PyTorch
versions, which the CUDA kernels are held to bit for bit on the card)
against the JAX reference: the jitted ``repro.kernels.ref`` oracles and
the Pallas kernels in interpret mode (``rows=1``), on the reference's own
``_gather_case`` inputs — a denormal row, an all-zero row, the zero pad
row and perm lengths 1-23 — plus a wide-dynamic-range case.

Tolerances: bit-exact (compared as int32 bit patterns, so the sign of
zero counts) for every output, except the sign rung's scale and the
residual derived from it: XLA sums ``mean|ef|`` in another order than the
port's fixed 4-lane-then-tree order, so the scale may differ by at most
8 ulp and the residual by at most 8 ulp of the scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.quantize import ef_int4_gather, quantize_int8_gather
from repro.kernels.sign import ef_sign_gather
from repro.kernels.topk_compress import LANES, ef_topk_gather
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CASES = [(2, 1, 0), (5, 7, 1), (9, 23, 2), (6, 13, 3), (4, 17, 4)]
SIGN_ULP = 8


def _gather_case(nbp1, S, seed, special):
    """The reference's tests/test_kernels.py:_gather_case at rows=1."""
    r = np.random.RandomState(seed)
    fb = r.randn(nbp1, LANES).astype(np.float32)
    eb = r.randn(nbp1, LANES).astype(np.float32)
    if special and nbp1 > 3:
        fb[0] *= 1e-41          # subnormal magnitudes
        eb[0] *= 1e-41
        fb[1] = 0.0             # absmax == 0 row
        eb[1] = 0.0
    fb[-1] = 0.0
    eb[-1] = 0.0
    perm = r.randint(0, nbp1, size=S).astype(np.int32)
    return fb, eb, perm


def _wide_case(seed=7, nbp1=24, S=40):
    """Rows spanning ~1e-30..1e30 in scale, so rounding edges get hit."""
    r = np.random.RandomState(seed)
    mag = np.exp(r.uniform(-60, 60, size=(nbp1, 1)))
    fb = (r.randn(nbp1, LANES) * mag).astype(np.float32)
    eb = (r.randn(nbp1, LANES) * mag).astype(np.float32)
    fb[-1] = eb[-1] = 0.0
    return fb, eb, r.randint(0, nbp1, size=S).astype(np.int32)


def _inputs():
    out = [_gather_case(n, S, seed, sp) for n, S, seed in CASES
           for sp in (False, True)]
    out.append(_wide_case())
    return out


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jax_fns(kind, gamma):
    if kind == "int8":
        return (lambda f, e, p: jref.quantize_int8_gather_ref(
                    f, e, p, gamma=gamma),
                lambda f, e, p: quantize_int8_gather(
                    f, e, p, gamma=gamma, rows=1, interpret=True))
    if kind == "int4":
        return (lambda f, e, p: jref.ef_int4_gather_ref(f, e, p, gamma=gamma),
                lambda f, e, p: ef_int4_gather(f, e, p, gamma=gamma, rows=1,
                                               interpret=True))
    if kind == "sign":
        return (lambda f, e, p: jref.ef_sign_gather_ref(f, e, p, gamma=gamma),
                lambda f, e, p: ef_sign_gather(f, e, p, gamma=gamma, rows=1,
                                               interpret=True))
    return (lambda f, e, p: jref.ef_topk_gather_ref(f, e, p, gamma=gamma,
                                                    k=104),
            lambda f, e, p: ef_topk_gather(f, e, p, gamma=gamma, k=104,
                                           rows=1, interpret=True))


def _port(kind, fb, eb, perm, gamma):
    f, e, p = (torch.from_numpy(x) for x in (fb, eb, perm))
    if kind == "int8":
        q, s, r, own = tops.gather_ef_int8(f, e, p, gamma=gamma)
    elif kind == "int4":
        q, s, r, own = tops.gather_ef_int4(f, e, p, gamma=gamma)
    elif kind == "sign":
        q, s, r, own = tops.gather_ef_sign(f, e, p, gamma=gamma)
    else:
        sel, r = tops.gather_ef_topk(f, e, p, gamma=gamma, k=104)
        return sel.numpy(), r.reshape(sel.shape).numpy()
    return (q.numpy(), s.numpy(), r.reshape(q.shape[0], LANES).numpy(),
            own.reshape(q.shape[0], LANES).numpy())


def _own_ref(gamma):
    """The reference codecs' ``own``: ef re-derived from the gathered rows
    minus the kernel's residual, under jit."""
    return jax.jit(lambda f, e, p, r: (f[p] + gamma * e[p]) - r)


def _assert_same(kind, got, want):
    if kind != "sign":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        return
    (sg, s, r), (sg_w, s_w, r_w) = got[:3], want
    np.testing.assert_array_equal(sg, np.asarray(sg_w))
    s_w = np.asarray(s_w)
    ulp = np.abs(_bits(s).astype(np.int64) - _bits(s_w).astype(np.int64))
    assert ulp.max() <= SIGN_ULP, ulp.max()
    tol = SIGN_ULP * np.spacing(np.abs(s_w)) + 0.0
    assert np.all(np.abs(r - np.asarray(r_w)) <= tol)
    # where the scales agree, the residual is bit-exact too
    same = (ulp == 0)[:, 0]
    np.testing.assert_array_equal(_bits(r[same]), _bits(np.asarray(r_w)[same]))


@pytest.mark.parametrize("gamma", [1.0, 0.9, 0.6])
@pytest.mark.parametrize("kind", ["int8", "int4", "sign", "topk"])
def test_gather_encode_matches_reference(kind, gamma):
    jit_ref, pallas = _jax_fns(kind, gamma)
    jit_ref = jax.jit(jit_ref)
    own_ref = _own_ref(gamma)
    for fb, eb, perm in _inputs():
        got = _port(kind, fb, eb, perm, gamma)
        args = (jnp.asarray(fb), jnp.asarray(eb), jnp.asarray(perm))
        want = jit_ref(*args)
        _assert_same(kind, got, want)
        _assert_same(kind, got, pallas(*args))
        if kind == "topk":
            continue
        # own = ef - r, which the port's kernel writes: bit-exact to the
        # reference's re-derivation from its own residual (sign: within
        # 8 ulp of the scale, as the residual)
        own_w = np.asarray(own_ref(*args, want[2].reshape(len(perm), LANES)))
        if kind == "sign":
            tol = SIGN_ULP * np.spacing(np.abs(np.asarray(want[1]))) + 0.0
            assert np.all(np.abs(got[3] - own_w) <= tol)
        else:
            np.testing.assert_array_equal(_bits(got[3]), _bits(own_w))


@pytest.mark.parametrize("kind", ["int8", "int4", "sign", "topk"])
def test_wrapper_shapes_and_cpu_path(kind):
    """CPU tensors take the plain version and count no launch; outputs
    have the reference ops wrappers' shapes."""
    fb, eb, perm = _gather_case(6, 5, 11, True)
    tops.reset_launch_counts()
    out = _port(kind, fb, eb, perm, 0.9)
    assert out[0].shape[0] == 5
    assert all(v == 0 for v in tops.launch_counts().values())


def test_wrappers_reject_bad_inputs():
    fb = torch.zeros(3, LANES)
    with pytest.raises(TypeError):
        tops.gather_ef_int8(fb, fb, torch.zeros(2, dtype=torch.int64),
                            gamma=1.0)
    with pytest.raises(ValueError):
        tops.gather_ef_int8(torch.zeros(3, 512), torch.zeros(3, 512),
                            torch.zeros(2, dtype=torch.int32), gamma=1.0)
    with pytest.raises(ValueError):
        tops.gather_ef_topk(fb, fb, torch.zeros(2, dtype=torch.int32),
                            gamma=1.0, k=0)


def test_fixed_sum_order_is_a_pairwise_tree():
    """The sign rung's row sum: 4 lanes left to right, then p[:s]+p[s:2s]."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, LANES)
                         .astype(np.float32))
    a = x.abs().numpy().reshape(2, 256, 4)
    p = ((a[..., 0] + a[..., 1]) + a[..., 2]) + a[..., 3]
    s = 128
    while s >= 1:
        p = p[:, :s] + p[:, s:2 * s]
        s //= 2
    np.testing.assert_array_equal(_bits(tref.row_abs_sum(x).numpy()),
                                  _bits(p))


def test_profile_names_every_port_kernel():
    """``launch/profile.py`` files the device time of every kernel the
    CUDA sources define (``__global__``) under a category of the port's
    own kernels, not under elementwise."""
    import re
    from pathlib import Path

    from repro_torch.launch.profile import category
    csrc = Path(tops.__file__).resolve().parent / "csrc"
    names = [m for f in sorted(csrc.glob("*.cu")) for m in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s+)?(\w+)",
        f.read_text())]
    assert len(names) == 3, names
    for name in names:
        assert "port kernel" in category(f"void (anonymous namespace)::"
                                         f"{name}<Body>(Body)"), name
