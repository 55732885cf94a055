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
