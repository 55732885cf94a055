"""Plain PyTorch versions of the port's kernels: the gather + error-feedback
encoders (``csrc/gather_encode.cu``, K1-K4), the flat encoders and the int8
dequantiser on contiguous rows (the same file, K12-K16) and the
decode-accumulate folds (``csrc/decode_accum.cu``, K5-K11; at the end of
this module).

Each function here computes, on any device, exactly what its CUDA kernel
computes: the CPU tests run these, and
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

import math

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
    a = x.abs().reshape(x.shape[0], x.shape[1] // VEC, VEC)
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


# ---- flat encoders on contiguous rows (K12-K16) ---------------------------
#
# The reference's ``quantize_int8_fused``, ``ef_int4_fused``,
# ``ef_sign_fused``, ``ef_topk_select`` and ``dequantize_int8`` on (R, LANES)
# rows: the same row bodies as the gather kernels, with their outputs and
# no ``own``.  K12 takes ``x`` with the error feedback already applied.


def quantize_int8_ref(x):
    """K12: -> (q (R, LANES) int8, scales (R, 1) f32, residual (R, LANES))."""
    x = ftz(x.float())
    q, scale = _quant_body(x)
    return q.to(torch.int8), scale, residual(x, q, scale)


def _int4_encode(ef):
    q, scale = _int4_body(ef)
    return pack_nibbles(q), scale, residual(ef, q, scale)


def _sign_encode(ef):
    sign, scale = _sign_body(ef)
    return sign.to(torch.int8), scale, residual(ef, sign, scale)


def ef_int4_ref(g, e, *, gamma: float):
    """K13: -> (packed (R, LANES // 2) uint8, scales (R, 1), residual)."""
    return _int4_encode(ef_accumulate(g, e, gamma))


def ef_sign_ref(g, e, *, gamma: float):
    """K14: -> (sign (R, LANES) int8, scales (R, 1), residual)."""
    return _sign_encode(ef_accumulate(g, e, gamma))


def _topk_select(ef, k: int):
    mask, _ = _select_body(ef, k)
    # ``ef * mask`` in the reference: XLA turns the product with a 0/1
    # mask into a select, so dropped entries are +0 whatever ef's sign
    sel = torch.where(mask > 0, ef, 0.0)
    return sel, ef - sel


def ef_topk_select_ref(g, e, *, gamma: float, k: int):
    """K15: -> (selected (R, LANES) f32, residual (R, LANES) f32)."""
    return _topk_select(ef_accumulate(g, e, gamma), k)


def dequantize_int8_ref(q, scales):
    """K16: q (R, LANES) int8 times its row scale (R, 1) -> f32."""
    return ftz(q.float() * ftz(scales.float()))


# ---- gather + EF + encode: one function per kernel ------------------------
#
# K1-K4 are K12-K15 on the rows ``perm`` of the packed buffers, plus
# ``own = ef - residual`` for the int8 / int4 / sign rungs.


def quantize_int8_gather_ref(fb, eb, perm, *, gamma: float):
    """-> (q (S, LANES) int8, scales (S, 1) f32, residual (S, LANES),
    own = ef - residual (S, LANES))."""
    ef = _gather_ef(fb, eb, perm, gamma)
    q, scale, r = quantize_int8_ref(ef)
    return q, scale, r, ftz(ef - r)


def ef_int4_gather_ref(fb, eb, perm, *, gamma: float):
    """-> (packed (S, LANES // 2) uint8, scales (S, 1), residual, own)."""
    ef = _gather_ef(fb, eb, perm, gamma)
    p, scale, r = _int4_encode(ef)
    return p, scale, r, ftz(ef - r)


def ef_sign_gather_ref(fb, eb, perm, *, gamma: float):
    """-> (sign (S, LANES) int8, scales (S, 1), residual, own)."""
    ef = _gather_ef(fb, eb, perm, gamma)
    sign, scale, r = _sign_encode(ef)
    return sign, scale, r, ftz(ef - r)


def ef_topk_gather_ref(fb, eb, perm, *, gamma: float, k: int):
    """-> (selected (S, LANES) f32, residual (S, LANES) f32)."""
    return _topk_select(_gather_ef(fb, eb, perm, gamma), k)


# ---- decode-accumulate: the folds of the multi-pod exchange ----------------
#
# Plain versions of the kernels in ``csrc/decode_accum.cu`` (the JAX
# package's ``repro/kernels/decode.py``).  As XLA:CPU runs the reference
# under ``jit``: ``acc + w * (q * scale)`` and ``mag + w * scale`` are one
# fused multiply-add on the rounded product ``q * scale`` (see
# :func:`fma_f32`), while top-k's scatter-add adds the rounded ``w * vals``
# (no FMA) and leaves the lanes it does not touch bit for bit as they were.

#: fractional bits of the deterministic fixed-point accumulator
FIXED_POINT_BITS = 16
#: largest f32 that casts to int32 without overflow (2^31 - 128)
INT32_SAT = 2147483520.0


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on f32 tensors with one rounding, denormals flushed.

    The product is exact in float64; the float64 sum is rounded to odd
    (its rounding error, found by TwoSum, decides the last bit), and a
    value rounded to odd with 29 bits to spare rounds to f32 exactly as
    the infinitely precise sum would.  Neither ``torch.addcmul`` nor
    ``a * b + c`` is one rounding on every device."""
    a, b, c = torch.broadcast_tensors(ftz(a), ftz(b), ftz(c))
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return ftz(s.float())


def fixed_point(x: torch.Tensor, bits: int = FIXED_POINT_BITS
                ) -> torch.Tensor:
    """f32 -> int32 fixed point: round half to even at ``bits`` fractional
    bits, saturating at +-INT32_SAT before the cast."""
    s = torch.round(ftz(x) * float(2.0 ** bits))
    return torch.clamp(s, -INT32_SAT, INT32_SAT).to(torch.int32)


def from_fixed_point(acc: torch.Tensor, bits: int = FIXED_POINT_BITS
                     ) -> torch.Tensor:
    """int32 fixed point -> f32 (round to nearest, then an exact scale by
    a power of two)."""
    return ftz(acc.float() * float(2.0 ** -bits))


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """(rows, C // 8) uint8 bit-packed -> (rows, C) f32 {-1, +1}; bit i of
    byte b is column 8b+i."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = ((packed[:, :, None] >> shifts) & 1).float()
    return bits.reshape(packed.shape[0], packed.shape[1] * 8) * 2.0 - 1.0


def _weighted(q, s, w):
    """(rows, C) f32 values q * s with its rounding, and the weight."""
    return ftz(q.float() * ftz(s)), ftz(w.reshape(()))


def dequant_accum_int8_ref(acc, q, s, w):
    """acc (rows, LANES) f32 + w * (q * s): q int8, s (rows, 1), w a
    one-element f32 tensor."""
    qs, wv = _weighted(q, s, w)
    return fma_f32(wv, qs, acc)


def dequant_accum_int4_ref(acc, p, s, w):
    """:func:`dequant_accum_int8_ref` on packed nibbles p (rows, LANES//2)."""
    return dequant_accum_int8_ref(acc, unpack_nibbles(p), s, w)


def sign_vote_accum_ref(vote, mag, p, s, w):
    """Majority-vote partials: (vote + w * signs, mag + w * s); p the
    bit-packed signs (rows, LANES // 8), mag and s (rows, 1)."""
    wv = ftz(w.reshape(()))
    return (fma_f32(wv, unpack_signs(p), vote),
            fma_f32(wv, ftz(s), mag))


def dequant_accum_int8_fp_ref(acc, q, s, w, bits: int):
    """acc (rows, LANES) int32 + fixed_point(w * (q * s)), wrapping."""
    qs, wv = _weighted(q, s, w)
    return acc + fixed_point(ftz(wv * qs), bits)


def dequant_accum_int4_fp_ref(acc, p, s, w, bits: int):
    """:func:`dequant_accum_int8_fp_ref` on packed nibbles."""
    return dequant_accum_int8_fp_ref(acc, unpack_nibbles(p), s, w, bits)


def sign_vote_accum_fp_ref(vote, mag, p, s, w, bits: int):
    """Integer vote counts ``vote + fixed_point(w) * (+-1)`` and the
    fixed-point magnitude ``mag + fixed_point(w * s)`` (int32, wrapping);
    omega is quantised once."""
    wv = ftz(w.reshape(()))
    wq = fixed_point(wv, bits)
    return (vote + wq * unpack_signs(p).to(torch.int32),
            mag + fixed_point(ftz(wv * ftz(s)), bits))


def topk_scatter_accum_ref(acc, q, idx, s, w):
    """acc (rows, LANES) f32 with ``w * (q * s)`` added at the lanes
    ``idx`` (rows, k) uint16 of each row (distinct within a row, as top-k
    gives them); the other lanes keep their bits."""
    vals, wv = _weighted(q, s, w)
    term = ftz(wv * vals)
    rows = torch.arange(acc.shape[0], device=acc.device)[:, None]
    lanes = idx.to(torch.int64)
    out = acc.clone()
    out[rows, lanes] = ftz(ftz(acc[rows, lanes]) + term)
    return out
