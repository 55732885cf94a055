"""Plain PyTorch versions of the gather + error-feedback encode kernels.

Each function here computes, on any device, exactly what its CUDA kernel in
``csrc/gather_encode.cu`` computes: the CPU tests run these, and
``chip_smoke.py`` holds every kernel against its plain version on the card
bit for bit.  They follow the JAX package's ``repro/kernels/ref.py``
(``quantize_int8_gather_ref`` and friends) as the reference runs them
under ``jit`` on XLA:CPU, which fixes three numerics rules:

* ``ef = g + gamma * e`` is one fused multiply-add.  ``torch.addcmul``
  computes it with a single rounding, as XLA's contraction does; so is the
  quantisation residual ``ef - q * scale`` (see :func:`residual`).
* Denormals are flushed to a zero of the same sign, on the inputs and on
  every intermediate that can underflow, as XLA:CPU (and the TPU) does.
  PyTorch keeps denormals, so :func:`ftz` is applied explicitly.
* ``absmax / 127`` is a multiplication by the f32 reciprocal (XLA rewrites
  division by a constant), while ``ef / scale`` is a true IEEE division.

The sign rung's ``mean|ef|`` is summed in a fixed order (4 contiguous
lanes, then a pairwise tree over the 256 partial sums) that the kernel
reproduces; XLA's own reduction order differs by a few ulp.
"""
from __future__ import annotations

import torch

LANES = 1024
#: lanes one kernel thread holds (the fixed sum order groups by these)
VEC = 4
BISECT_ITERS = 16
SCALE_FLOOR = 1e-30
#: smallest normal f32; anything below is flushed
_TINY = 1.1754943508222875e-38
INV127 = 1.0 / 127.0
INV7 = 1.0 / 7.0
INV_LANES = 1.0 / LANES


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush f32 denormals to a zero of the same sign (``x * 0`` keeps
    the sign)."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def ef_accumulate(g: torch.Tensor, e: torch.Tensor,
                  gamma: float) -> torch.Tensor:
    """``g + gamma * e`` as one fused multiply-add, denormals flushed."""
    gam = torch.tensor(gamma, dtype=torch.float32, device=g.device)
    return ftz(torch.addcmul(ftz(g.float()), ftz(e.float()), gam))


def _gather_ef(fb, eb, perm, gamma: float) -> torch.Tensor:
    return ef_accumulate(fb.index_select(0, perm),
                         eb.index_select(0, perm), gamma)


def _absmax_quant(x, inv: float, qmax: float):
    """Shared absmax quantiser: (q as f32, scale (rows, 1))."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax * inv, SCALE_FLOOR)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q, scale


def _quant_body(x):
    """int8 rung math: absmax/127 scale, round half to even, clip."""
    return _absmax_quant(x, INV127, 127.0)


def _int4_body(x):
    """int4 rung math: absmax/7 scale, round half to even, clip."""
    return _absmax_quant(x, INV7, 7.0)


def residual(ef, q, scale):
    """``ef - q * scale`` with one rounding (the reference's FMA).

    Computed in float64, where it is exact: ``q * scale`` needs at most
    32 significant bits, and when q != 0, |ef| >= scale / 2 bounds the
    difference to ~33 bits — so the one rounding to f32 is the FMA's.
    (``addcmul`` with ``value=-1`` is not one FMA on CUDA.)"""
    r = ef.double() - q.double() * scale.double()
    return ftz(r.float())


def pack_nibbles(q):
    """(rows, C) f32 in [-7, 7] -> (rows, C // 2) uint8 (offset binary
    q+8; even column in the low nibble)."""
    u = (q + 8.0).to(torch.uint8)
    u3 = u.reshape(q.shape[0], q.shape[1] // 2, 2)
    return u3[..., 0] | (u3[..., 1] << 4)


def unpack_nibbles(packed):
    """Inverse of :func:`pack_nibbles` -> (rows, 2 * C') f32."""
    lo = (packed & 0xF).float() - 8.0
    hi = (packed >> 4).float() - 8.0
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0],
                                                 packed.shape[1] * 2)


def row_abs_sum(x):
    """Per-row sum of ``|x|`` over LANES in the kernel's fixed order:
    each of the 256 threads adds its 4 contiguous lanes left to right,
    then the partial sums are folded pairwise, ``p[:s] + p[s:2s]`` for
    s = 128, 64, ..., 1 (the kernel's shared-memory and shuffle tree)."""
    a = x.abs().reshape(x.shape[0], -1, VEC)
    p = a[..., 0]
    for j in range(1, VEC):
        p = p + a[..., j]
    s = p.shape[1] // 2
    while s >= 1:
        p = p[:, :s] + p[:, s:2 * s]
        s //= 2
    return p                                           # (rows, 1)


def _sign_body(x):
    """1-bit sign rung math: sign (+1 where x >= 0), mean |x| scale."""
    scale = ftz(row_abs_sum(x) * INV_LANES)
    sign = torch.where(x >= 0, 1.0, -1.0)
    return sign, scale


def _select_body(ef, k: int):
    """Per-row bisection threshold for ~k kept entries (16 fixed steps on
    |ef|).  Returns (mask f32, threshold (rows, 1))."""
    mag = ef.abs()
    hi = mag.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ITERS):
        mid = ftz((lo + hi) * 0.5)
        cnt = (mag >= mid).sum(dim=-1, keepdim=True)
        take_hi = cnt > k          # too many selected -> raise threshold
        lo = torch.where(take_hi, mid, lo)
        hi = torch.where(take_hi, hi, mid)
    thr = ftz((lo + hi) * 0.5)
    return (mag >= thr).float(), thr


# ---- gather + EF + encode: one function per kernel ------------------------


def quantize_int8_gather_ref(fb, eb, perm, *, gamma: float):
    """-> (q (S, LANES) int8, scales (S, 1) f32, residual (S, LANES),
    own = ef - residual (S, LANES))."""
    ef = _gather_ef(fb, eb, perm, gamma)
    q, scale = _quant_body(ef)
    r = residual(ef, q, scale)
    return q.to(torch.int8), scale, r, ftz(ef - r)


def ef_int4_gather_ref(fb, eb, perm, *, gamma: float):
    """-> (packed (S, LANES // 2) uint8, scales (S, 1), residual, own)."""
    ef = _gather_ef(fb, eb, perm, gamma)
    q, scale = _int4_body(ef)
    r = residual(ef, q, scale)
    return pack_nibbles(q), scale, r, ftz(ef - r)


def ef_sign_gather_ref(fb, eb, perm, *, gamma: float):
    """-> (sign (S, LANES) int8, scales (S, 1), residual, own)."""
    ef = _gather_ef(fb, eb, perm, gamma)
    sign, scale = _sign_body(ef)
    r = residual(ef, sign, scale)
    return sign.to(torch.int8), scale, r, ftz(ef - r)


def ef_topk_gather_ref(fb, eb, perm, *, gamma: float, k: int):
    """-> (selected (S, LANES) f32, residual (S, LANES) f32)."""
    ef = _gather_ef(fb, eb, perm, gamma)
    mask, _ = _select_body(ef, k)
    # ``ef * mask`` in the reference: XLA turns the product with a 0/1
    # mask into a select, so dropped entries are +0 whatever ef's sign
    sel = torch.where(mask > 0, ef, 0.0)
    return sel, ef - sel
