"""Parity of the port's codecs with the JAX reference codecs: ``encode`` /
``decode``, the packed wire bytes of ``pack_payload``, and the
producer-fused ``ef_encode_gather`` (the reference run with
``use_pallas=True``, i.e. its Pallas gather kernels interpreted at
``rows=1``), all on the same seeded numpy inputs.

Tolerances: bit-exact everywhere (compared as int32 bit patterns for
f32), except the sign rung's scale — XLA sums ``mean|x|`` in another order
than the port's fixed order — which may differ by at most 8 ulp, and the
values derived from it by at most 8 ulp of the scale.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codecs import build_codec as jbuild
from repro.codecs import pack_payload as jpack
from repro_torch.codecs import build_codec as tbuild
from repro_torch.codecs import pack_payload as tpack
from repro_torch.codecs import unpack_payload as tunpack
from repro_torch.codecs import pack_bits, unpack_bits

SIGN_ULP = 8
CODECS = [("full", {}), ("int8", {}), ("int4", {}), ("sign", {}),
          ("topk", {"ratio": 0.25}), ("topk", {"ratio": 0.1}),
          ("topk", {"ratio": 0.01})]


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a


def _blocks(seed, nb=6, ties=False):
    r = np.random.RandomState(seed)
    x = (r.randn(nb, 1024) * np.exp(r.randn(nb, 1) * 2)).astype(np.float32)
    x[1] = 0.0                                   # an all-zero block
    if ties:
        # heavy ties: few distinct magnitudes, signs mixed, many zeros
        x[2] = r.choice([-2.0, -1.0, 0.0, 1.0, 2.0], size=1024)
        x[3, : 900] = 0.0
        x[4] = np.where(r.rand(1024) < 0.5, 3.0, -3.0)
    return x


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:       # compare bf16 by its bits
            return x.view(torch.int16).numpy().view(np.uint16)
        if x.dtype == torch.uint16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _assert_payload(name, got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = _np(got[k]), np.asarray(want[k])
        if name == "sign" and k == "scale":
            ulp = np.abs(_bits(g).astype(np.int64)
                         - _bits(w).astype(np.int64))
            assert ulp.max() <= SIGN_ULP, ulp.max()
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name,kw", CODECS,
                         ids=[f"{n}{kw.get('ratio', '')}" for n, kw in
                              CODECS])
def test_encode_decode_and_wire_bytes(name, kw, ties):
    x = _blocks(3, ties=ties)
    jc, tc = jbuild(name, **kw), tbuild(name, **kw)
    want = jax.jit(jc.encode)(jnp.asarray(x))
    got = tc.encode(_t(x))
    _assert_payload(name, got, want)
    # decode the port's own payload, compare with the reference decode of
    # the reference payload
    dec_w = np.asarray(jax.jit(lambda p: jc.decode(p))(want))
    dec_g = _np(tc.decode(got))
    if name == "sign":
        s = np.asarray(want["scale"])[:, None]
        assert np.all(np.abs(dec_g - dec_w) <= SIGN_ULP * np.spacing(s))
    else:
        np.testing.assert_array_equal(_bits(dec_g), _bits(dec_w))
    # packed wire: same bytes, same length as the analytic payload size
    if name != "sign":
        wire_w, _ = jpack(want)
        wire_g, meta = tpack(got)
        np.testing.assert_array_equal(_np(wire_g), np.asarray(wire_w))
        back = tunpack(wire_g, meta)
        for k in got:
            assert torch.equal(back[k], got[k])
    if name != "full":
        wire_g, _ = tpack(got)
        assert wire_g.numel() == tc.payload_bytes(x.size)
    assert tc.wire_bytes(x.size, 3) == jc.wire_bytes(x.size, 3)


def test_sign_wire_bytes_match_when_scales_match():
    """Sign payload bytes: the bit-packed signs are identical, and so is
    the whole wire once the reference's scale is used."""
    x = _blocks(5)
    want = jax.jit(jbuild("sign").encode)(jnp.asarray(x))
    got = tbuild("sign").encode(_t(x))
    got["scale"] = _t(np.asarray(want["scale"]))
    np.testing.assert_array_equal(_np(tpack(got)[0]),
                                  np.asarray(jpack(want)[0]))


def test_topk_tie_order_is_lower_index_first():
    x = np.zeros((1, 1024), np.float32)
    x[0, [5, 9, 700, 3]] = [1.0, -1.0, 1.0, 0.5]
    p = tbuild("topk", ratio=0.01).encode(_t(x))
    # k = 16: the three |1| entries by index, then 0.5, then zeros by index
    want = [5, 9, 700, 3] + [i for i in range(1024)
                             if i not in (3, 5, 9, 700)][:12]
    assert p["idx"].long()[0].tolist() == want


def test_bit_pack_roundtrip():
    b = torch.from_numpy(np.random.RandomState(0).rand(3, 64) > 0.5)
    np.testing.assert_array_equal(unpack_bits(pack_bits(b), 64).bool(), b)


@pytest.mark.parametrize("name,kw", [c for c in CODECS if c[0] != "full"]
                         + [("skip", {})],
                         ids=[f"{n}{kw.get('ratio', '')}" for n, kw in
                              CODECS if n != "full"] + ["skip"])
def test_ef_sync_gather_matches_reference_kernel_path(name, kw):
    """One rung's gather + EF + encode + single-pod aggregate, against the
    reference with its producer-fused kernels (Pallas, interpreted)."""
    r = np.random.RandomState(11)
    fb = r.randn(9, 1024).astype(np.float32)
    eb = r.randn(9, 1024).astype(np.float32)
    fb[0] *= 1e-41
    fb[-1] = eb[-1] = 0.0
    perm = np.array([3, 0, 7, 8, 8, 2], np.int32)
    jc, tc = jbuild(name, **kw), tbuild(name, **kw)
    one = jnp.ones((1,), jnp.float32)

    @jax.jit
    def ref(f, e, p):
        return jc.ef_sync_gather(f, e, p, one, one[0], gamma=0.9, n_pods=1,
                                 use_pallas=True)

    agg_w, err_w = map(np.asarray, ref(jnp.asarray(fb), jnp.asarray(eb),
                                       jnp.asarray(perm)))
    one_t = torch.ones(1)
    agg_g, err_g = tc.ef_sync_gather(_t(fb), _t(eb), _t(perm), one_t,
                                     one_t[0], gamma=0.9, n_pods=1)
    agg_g, err_g = _np(agg_g), _np(err_g)
    if name == "sign":
        s = np.abs(agg_w).reshape(len(perm), 1024)[:, :1]
        tol = (SIGN_ULP * np.spacing(s) * np.ones((1, 1024))).reshape(-1)
        assert np.all(np.abs(agg_g - agg_w) <= tol)
        assert np.all(np.abs(err_g - err_w) <= tol)
    else:
        np.testing.assert_array_equal(_bits(agg_g), _bits(agg_w))
        np.testing.assert_array_equal(_bits(err_g), _bits(err_w))


def test_multi_pod_paths_raise():
    """The two-tier, one-shot and ring multi-pod rounds without their pod
    groups raise, and so does a float ring fold in arrival order on 3
    pods."""
    c = tbuild("int8")
    one = torch.ones(2)
    for mode in (1, 2):
        with pytest.raises(ValueError, match="pod group"):
            c.ef_sync_hier(torch.zeros(2048), torch.zeros(2048), one,
                           one[0], gamma=1.0, n_cross=2, n_edge=2,
                           intra_mode=mode)
    with pytest.raises(ValueError, match="pod group"):
        c.ef_sync_gather(torch.zeros(2, 1024), torch.zeros(2, 1024),
                         torch.zeros(1, dtype=torch.int32), one, one[0],
                         gamma=1.0, n_pods=2)
    with pytest.raises(ValueError, match="pod group"):
        c.ef_sync_ring(torch.zeros(2048), torch.zeros(2048), one, one[0],
                       gamma=1.0, n_pods=2, n_chunks=2)

    class Three:
        size = 3

    with pytest.raises(ValueError, match="drifts across pods"):
        c.ef_sync_ring(torch.zeros(2048), torch.zeros(2048),
                       torch.ones(3), one[0], gamma=1.0, n_pods=3,
                       n_chunks=2, pods=Three(), deterministic=False)


@pytest.mark.parametrize("name,kw", [c for c in CODECS if c[0] != "full"],
                         ids=[f"{n}{kw.get('ratio', '')}" for n, kw in
                              CODECS if n != "full"])
def test_ef_encode_gather_wire_matches_reference(name, kw):
    """The producer-fused encode's payload — what goes on the wire — is
    the reference's byte for byte (sign: the scale within 8 ulp)."""
    r = np.random.RandomState(21)
    fb = (r.randn(12, 1024) * np.exp(r.randn(12, 1) * 3)).astype(np.float32)
    eb = r.randn(12, 1024).astype(np.float32)
    fb[2] = eb[2] = 0.0
    fb[-1] = eb[-1] = 0.0
    perm = np.array([5, 2, 11, 0, 7, 7, 3], np.int32)
    jc, tc = jbuild(name, **kw), tbuild(name, **kw)
    want, _, _ = jax.jit(lambda f, e, p: jc.ef_encode_gather(
        f, e, p, gamma=0.6, use_pallas=True))(
        jnp.asarray(fb), jnp.asarray(eb), jnp.asarray(perm))
    got, _, _ = tc.ef_encode_gather(_t(fb), _t(eb), _t(perm), gamma=0.6)
    _assert_payload(name, got, want)
    if name != "sign":
        np.testing.assert_array_equal(_np(tpack(got)[0]),
                                      np.asarray(jpack(want)[0]))


@pytest.mark.parametrize("name,kw", [c for c in CODECS
                                     if c[0] not in ("full", "skip")],
                         ids=[f"{n}{kw.get('ratio', '')}" for n, kw in
                              CODECS if n not in ("full", "skip")])
def test_fused_codecs_refuse_other_block_sizes(name, kw):
    """The gather + EF kernels encode 1024-entry rows only: another block
    size is an error, not a detour through a plain path."""
    fb = torch.zeros(3, 512)
    with pytest.raises(NotImplementedError, match="1024"):
        tbuild(name, **kw).ef_encode_gather(
            fb, fb, torch.zeros(1, dtype=torch.int32), gamma=1.0, block=512)
