"""Tests of the port that need the card: each Hopper kernel against its
plain PyTorch version on CUDA tensors, bit for bit, and the wrappers'
launch counting.  They skip without a CUDA device; on the card run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
LANES = 1024


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, nbp1=40, S=57, seed=0):
    r = np.random.RandomState(seed)
    fb = (r.randn(nbp1, LANES) * np.exp(r.randn(nbp1, 1) * 4)) \
        .astype(np.float32)
    eb = r.randn(nbp1, LANES).astype(np.float32)
    fb[0] *= 1e-41
    eb[0] *= 1e-41
    fb[1] = eb[1] = 0.0
    fb[-1] = eb[-1] = 0.0
    perm = r.randint(0, nbp1, size=S).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (fb, eb, perm)]


PLAIN = {"int8": ref.quantize_int8_gather_ref, "int4": ref.ef_int4_gather_ref,
         "sign": ref.ef_sign_gather_ref}
#: k of the 25 / 10 / 1 % top-k rungs, all of which the main path runs
TOPK_KS = (256, 104, 16)


def _pairs(kind):
    """(kernel wrapper, plain version) pairs as f(fb, eb, perm, gamma)."""
    if kind == "topk":
        return [(lambda f, e, p, g, k=k: ops.gather_ef_topk(f, e, p, gamma=g,
                                                            k=k),
                 lambda f, e, p, g, k=k: ref.ef_topk_gather_ref(
                     f, e, p, gamma=g, k=k)) for k in TOPK_KS]
    kern, plain = getattr(ops, f"gather_ef_{kind}"), PLAIN[kind]
    return [(lambda f, e, p, g: kern(f, e, p, gamma=g),
             lambda f, e, p, g: plain(f, e, p, gamma=g))]


@pytest.mark.parametrize("kind", ["int4", "int8", "sign", "topk"])
def test_kernel_bit_exact_to_plain_version(dev, kind):
    for kern, plain in _pairs(kind):
        for seed in range(3):
            fb, eb, perm = _case(dev, seed=seed)
            for gamma in (1.0, 0.9, 0.6):
                got = kern(fb, eb, perm, gamma)
                want = plain(fb, eb, perm, gamma)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    b = b.reshape(a.shape)
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    assert torch.equal(a, b)


def test_launch_counts(dev):
    fb, eb, perm = _case(dev)
    ops.reset_launch_counts()
    ops.gather_ef_int8(fb, eb, perm, gamma=1.0)
    ops.gather_ef_int8(fb, eb, perm[:0], gamma=1.0)   # S = 0: no launch
    assert ops.launch_counts()["gather_ef_int8"] == 1


def _decode_case(dev, rows=37, k=104, seed=0):
    r = np.random.RandomState(seed)
    acc = (r.randn(rows, LANES) * np.exp(r.randn(rows, 1))).astype(
        np.float32)
    acc[1] = 0.0
    acc[2, ::3] *= np.float32(1e-41)
    acc[3, ::5] = np.float32(-0.0)
    s = (np.abs(r.randn(rows)) * 0.01).astype(np.float32)
    s[4], s[5] = 0.0, np.float32(3e-39)
    idx = np.stack([r.permutation(LANES)[:k] for _ in range(rows)])
    x = {"acc": acc, "s": s,
         "iacc": r.randint(-2 ** 31, 2 ** 31, (rows, LANES)).astype(np.int32),
         "q": r.randint(-127, 128, (rows, LANES)).astype(np.int8),
         "nib": r.randint(0, 256, (rows, LANES // 2)).astype(np.uint8),
         "sgn": r.randint(0, 256, (rows, LANES // 8)).astype(np.uint8),
         "mag": r.randn(rows).astype(np.float32),
         "imag": r.randint(-2 ** 31, 2 ** 31, rows).astype(np.int32),
         "qk": r.randint(-127, 128, (rows, k)).astype(np.int8),
         "idx": idx.astype(np.uint16)}
    return {n: torch.from_numpy(v).to(dev) for n, v in x.items()}


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b.reshape(a.shape))


@pytest.mark.parametrize("bits", [None, 16, 30])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decode_accum_bit_exact_to_plain_version(dev, kind, bits):
    """K5 / K6 (bits None) and K9 / K10 (fixed point) on the card."""
    x = _decode_case(dev)
    src = x["q"] if kind == "int8" else x["nib"]
    fn = getattr(ops, f"decode_accum_{kind}")
    for w in (0.37, 0.0, 1.0):
        wt = torch.tensor(w, device=dev)
        acc = x["acc"] if bits is None else x["iacc"]
        got = fn(acc, src, x["s"], wt, fixed_bits=bits)
        s2 = x["s"][:, None]
        if bits is None:
            plain = getattr(ref, f"dequant_accum_{kind}_ref")
            want = plain(acc, src, s2, wt)
        else:
            plain = getattr(ref, f"dequant_accum_{kind}_fp_ref")
            want = plain(acc, src, s2, wt, bits)
        torch.cuda.synchronize()
        assert _same(got, want)


@pytest.mark.parametrize("bits", [None, 16])
def test_sign_vote_accum_bit_exact_to_plain_version(dev, bits):
    """K7 (bits None) and K11 on the card."""
    x = _decode_case(dev)
    wt = torch.tensor(0.37, device=dev)
    if bits is None:
        got = ops.sign_vote_accum(x["acc"], x["mag"], x["sgn"], x["s"], wt)
        want = ref.sign_vote_accum_ref(x["acc"], x["mag"][:, None], x["sgn"],
                                       x["s"][:, None], wt)
    else:
        got = ops.sign_vote_accum(x["iacc"], x["imag"], x["sgn"], x["s"],
                                  wt, fixed_bits=bits)
        want = ref.sign_vote_accum_fp_ref(x["iacc"], x["imag"][:, None],
                                          x["sgn"], x["s"][:, None], wt,
                                          bits)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", TOPK_KS)
def test_topk_scatter_accum_bit_exact_to_plain_version(dev, k):
    """K8 on the card, -0 and denormals in untouched lanes kept."""
    x = _decode_case(dev, k=k)
    wt = torch.tensor(0.37, device=dev)
    got = ops.topk_scatter_accum(x["acc"], x["qk"], x["idx"], x["s"], wt)
    want = ref.topk_scatter_accum_ref(x["acc"], x["qk"], x["idx"],
                                      x["s"][:, None], wt)
    torch.cuda.synchronize()
    assert _same(got, want)
