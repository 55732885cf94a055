"""Wrappers of the port's Hopper kernels: the gather + error-feedback
encoders (K1-K4), the flat encoders of the ring exchange and the int8
dequantiser (K12-K16), and the decode-accumulate folds of the multi-pod
exchange (K5-K11).

Each wrapper picks the kernel or its plain version from the device of the
tensors alone: tensors on the CPU take the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; CUDA tensors launch the hand-written
Hopper kernel (``csrc/gather_encode.cu``, built on first use by
:mod:`repro_torch.kernels.build`) and raise if the build or the launch
fails.  Nothing falls back.

Counterparts of ``repro/kernels/ops.py:gather_ef_*``: they read one
rung's rows straight out of the packed (NB+1, LANES) grad / error buffers
through the plan's gather perm.  Pad perm entries point at the zero row
NB.  The int8 / int4 / sign wrappers also return ``own = ef - residual``,
the rows every receiver reconstructs, written by the kernel itself.

Counterparts of ``repro/kernels/ops.py:quantize_int8``, ``ef_int4``,
``ef_sign``, ``ef_topk`` and ``dequant_int8``: they take flat (n,) f32
buffers, lay them out as ceil(n / LANES) rows (zero-padding the tail row;
the reference pads to 8-row tiles, which the card does not need) and
return what the reference's return, the residual and selection sliced to
``n``.  They write no ``own``.

Counterparts of ``repro/kernels/ops.py:decode_accum_*``,
``sign_vote_accum`` and ``topk_scatter_accum``: one peer's payload rows
folded into the running aggregate, ``acc + w * decode(payload)``, in f32
or (``fixed_bits`` set) in int32 fixed point.  They return a fresh
accumulator, as the reference's do.

Every kernel launch adds one to its entry in :data:`LAUNCHES` (and
nothing else does), so a run can show that its main path went through the
kernels.

Tensors on the meta device (a dry run, ``launch/dryrun.py``) take a third
branch: the wrapper allocates its outputs' shapes and dtypes on meta and
records the launch it would make — its name, rows and bytes by the
kernels' table (``kernels/table.py``) — in :data:`DRY_LAUNCHES`.  It
builds nothing, launches nothing and runs no plain version; a ``cpu`` or
``cuda`` tensor never takes it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.table import row_bytes

LANES = ref.LANES

KERNELS = ("gather_ef_int8", "gather_ef_int4", "gather_ef_sign",
           "gather_ef_topk", "decode_accum_int8", "decode_accum_int4",
           "sign_vote_accum", "topk_scatter_accum", "decode_accum_int8_fp",
           "decode_accum_int4_fp", "sign_vote_accum_fp", "quantize_int8",
           "ef_int4", "ef_sign", "ef_topk", "dequant_int8")
#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
#: the launches wrappers given meta tensors would have made, in order:
#: (name, rows, bytes)
DRY_LAUNCHES: List[Tuple[str, int, int]] = []


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _devtype(dev: torch.device) -> str:
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check(fb: torch.Tensor, eb: torch.Tensor, perm: torch.Tensor) -> str:
    """Validate the buffers; returns the device type ('cpu', 'cuda' or
    'meta')."""
    if fb.dtype != torch.float32 or eb.dtype != torch.float32:
        raise TypeError(f"fb/eb must be float32, got {fb.dtype}/{eb.dtype}")
    if fb.dim() != 2 or fb.shape[1] != LANES or eb.shape != fb.shape:
        raise ValueError(f"fb/eb must be (NB+1, {LANES}) of one shape, got "
                         f"{tuple(fb.shape)} / {tuple(eb.shape)}")
    if perm.dtype != torch.int32 or perm.dim() != 1:
        raise TypeError(f"perm must be 1-D int32, got {perm.dtype} "
                        f"{tuple(perm.shape)}")
    dev = fb.device
    if eb.device != dev or perm.device != dev:
        raise ValueError("fb, eb and perm must live on one device")
    if dev.type == "cuda":
        if not (fb.is_contiguous() and eb.is_contiguous()
                and perm.is_contiguous()):
            raise ValueError("the CUDA kernels need contiguous inputs")
    return _devtype(dev)


def _launch(name: str, rows: int, like: torch.Tensor, *args,
            k: Optional[int] = None) -> None:
    """Launch ``name`` over ``rows`` rows (0: no launch); on the meta
    device (``like``'s) record it in :data:`DRY_LAUNCHES` instead, its
    bytes by the table (top-k's scatter at its ``k``)."""
    if rows == 0:
        return
    if like.device.type == "meta":
        DRY_LAUNCHES.append((name, int(rows),
                             int(rows) * row_bytes(name, k)))
        return
    from repro_torch.kernels import build
    rc = getattr(build.load(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1


def _common(fb, eb, perm, gamma):
    stream = _stream(fb)
    return ((fb.data_ptr(), eb.data_ptr(), perm.data_ptr(),
             int(perm.shape[0]), int(fb.shape[0]), float(gamma)), stream)


def _quantised(name, plain, fb, eb, perm, gamma, q_cols, q_dtype):
    """Shared body of the int8 / int4 / sign wrappers -> (q (S, q_cols),
    scales (S, 1) f32, residual (S*LANES,), own = ef - residual
    (S*LANES,))."""
    if _check(fb, eb, perm) == "cpu":
        q, s, r, own = plain(fb, eb, perm, gamma=gamma)
        return q, s, r.reshape(-1), own.reshape(-1)
    S = perm.shape[0]
    q = torch.empty((S, q_cols), dtype=q_dtype, device=fb.device)
    s = torch.empty((S, 1), dtype=torch.float32, device=fb.device)
    r = torch.empty((S, LANES), dtype=torch.float32, device=fb.device)
    own = torch.empty((S, LANES), dtype=torch.float32, device=fb.device)
    args, stream = _common(fb, eb, perm, gamma)
    _launch(name, S, fb, *args, q.data_ptr(), s.data_ptr(), r.data_ptr(),
            own.data_ptr(), stream)
    return q, s, r.reshape(-1), own.reshape(-1)


def gather_ef_int8(fb, eb, perm, *, gamma: float):
    """Fused gather + EF + int8 encode of one rung's rows.
    Returns (q (S, LANES) int8, scales (S, 1) f32, residual (S*LANES,),
    own (S*LANES,))."""
    return _quantised("gather_ef_int8", ref.quantize_int8_gather_ref, fb, eb,
                      perm, gamma, LANES, torch.int8)


def gather_ef_int4(fb, eb, perm, *, gamma: float):
    """Fused gather + EF + packed-int4 encode of one rung's rows.
    Returns (packed (S, LANES//2) uint8, scales (S, 1) f32,
    residual (S*LANES,), own (S*LANES,))."""
    return _quantised("gather_ef_int4", ref.ef_int4_gather_ref, fb, eb, perm,
                      gamma, LANES // 2, torch.uint8)


def gather_ef_sign(fb, eb, perm, *, gamma: float):
    """Fused gather + EF + 1-bit sign encode of one rung's rows.
    Returns (sign (S, LANES) int8, scales (S, 1) f32, residual (S*LANES,),
    own (S*LANES,))."""
    return _quantised("gather_ef_sign", ref.ef_sign_gather_ref, fb, eb, perm,
                      gamma, LANES, torch.int8)


def gather_ef_topk(fb, eb, perm, *, gamma: float, k: int):
    """Fused gather + EF + block top-k selection of one rung's rows.
    Returns (selected (S, LANES) f32, residual (S*LANES,))."""
    if not 0 < k <= LANES:
        raise ValueError(f"k must be in (0, {LANES}], got {k}")
    if _check(fb, eb, perm) == "cpu":
        sel, res = ref.ef_topk_gather_ref(fb, eb, perm, gamma=gamma, k=k)
        return sel, res.reshape(-1)
    S = perm.shape[0]
    sel = torch.empty((S, LANES), dtype=torch.float32, device=fb.device)
    r = torch.empty((S, LANES), dtype=torch.float32, device=fb.device)
    (fbp, ebp, pp, S_, nbp1, gam), stream = _common(fb, eb, perm, gamma)
    _launch("gather_ef_topk", S, fb, fbp, ebp, pp, S_, nbp1, gam, int(k),
            sel.data_ptr(), r.data_ptr(), stream)
    return sel, r.reshape(-1)


# ---- decode-accumulate (K5-K11) -------------------------------------------


def _vec_aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def _decode_device(acc, payload, s, w, acc_dtype, pay_dtype, pay_cols,
                   vec) -> str:
    """Validate one fold's operands; returns the device type.  ``vec`` is
    the payload bytes a kernel thread loads at once (its alignment)."""
    nb = acc.shape[0] if acc.dim() == 2 else -1
    if acc.dtype != acc_dtype or acc.dim() != 2 or acc.shape[1] != LANES:
        raise ValueError(f"acc must be (nb, {LANES}) {acc_dtype}, got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    if payload.dtype != pay_dtype or tuple(payload.shape) != (nb, pay_cols):
        raise ValueError(f"payload must be ({nb}, {pay_cols}) {pay_dtype}, "
                         f"got {payload.dtype} {tuple(payload.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (nb,):
        raise ValueError(f"scales must be ({nb},) float32, got {s.dtype} "
                         f"{tuple(s.shape)}")
    if w.dtype != torch.float32 or w.numel() != 1:
        raise ValueError(f"w must be one float32, got {w.dtype} "
                         f"{tuple(w.shape)}")
    dev = acc.device
    if any(t.device != dev for t in (payload, s, w)):
        raise ValueError("acc, payload, scales and w must live on one "
                         "device")
    if dev.type == "cuda":
        if not all(t.is_contiguous() for t in (acc, payload, s)):
            raise ValueError("the CUDA kernels need contiguous operands")
        if not (_vec_aligned(acc, 16) and _vec_aligned(payload, vec)
                and _vec_aligned(s, 4) and _vec_aligned(w, 4)):
            raise ValueError("the CUDA kernels need 16-byte aligned "
                             f"accumulators and {vec}-byte aligned "
                             "payload rows")
    return _devtype(dev)


def _fixed(fixed_bits):
    if fixed_bits is None:
        return None
    bits = int(fixed_bits)
    if not 0 <= bits <= 100:
        raise ValueError(f"fixed_bits must be in [0, 100], got {bits}")
    return bits


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s card (0 on the meta device)."""
    if t.device.type == "meta":
        return 0
    return torch.cuda.current_stream(t.device).cuda_stream


def _dequant(kind, acc, payload, s, w, fixed_bits):
    bits = _fixed(fixed_bits)
    int8 = kind == "int8"
    acc_dtype = torch.float32 if bits is None else torch.int32
    dev = _decode_device(acc, payload, s, w, acc_dtype,
                         torch.int8 if int8 else torch.uint8,
                         LANES if int8 else LANES // 2, 4 if int8 else 2)
    w = w.reshape(())
    if dev == "cpu":
        s2 = s.reshape(-1, 1)
        if bits is None:
            fn = (ref.dequant_accum_int8_ref if int8
                  else ref.dequant_accum_int4_ref)
            return fn(acc, payload, s2, w)
        fn = (ref.dequant_accum_int8_fp_ref if int8
              else ref.dequant_accum_int4_fp_ref)
        return fn(acc, payload, s2, w, bits)
    out = torch.empty_like(acc)
    name = f"decode_accum_{kind}" + ("" if bits is None else "_fp")
    head = (acc.data_ptr(), payload.data_ptr(), s.data_ptr(), w.data_ptr(),
            int(acc.shape[0]))
    tail = (() if bits is None else (bits,)) + (out.data_ptr(),
                                                _stream(acc))
    _launch(name, int(acc.shape[0]), acc, *head, *tail)
    return out


def decode_accum_int8(acc, q, s, w, *, fixed_bits=None):
    """acc (nb, LANES) + w * (q * s): q (nb, LANES) int8, s (nb,) f32, w a
    one-element f32 tensor.  ``fixed_bits`` set: the int32 fixed-point
    accumulator (K9), else f32 (K5)."""
    return _dequant("int8", acc, q, s, w, fixed_bits)


def decode_accum_int4(acc, p, s, w, *, fixed_bits=None):
    """:func:`decode_accum_int8` on packed nibbles p (nb, LANES // 2) uint8
    (K10 / K6)."""
    return _dequant("int4", acc, p, s, w, fixed_bits)


def sign_vote_accum(vote, mag, p, s, w, *, fixed_bits=None):
    """Majority-vote partials -> (vote + w * signs, mag + w * s): vote
    (nb, LANES), mag (nb,), p (nb, LANES // 8) uint8 bit-packed signs.
    ``fixed_bits`` set: integer votes and fixed-point magnitude (K11),
    else f32 (K7)."""
    bits = _fixed(fixed_bits)
    acc_dtype = torch.float32 if bits is None else torch.int32
    dev = _decode_device(vote, p, s, w, acc_dtype, torch.uint8, LANES // 8,
                         1)
    nb = vote.shape[0]
    if mag.dtype != acc_dtype or tuple(mag.shape) != (nb,) \
            or mag.device != vote.device:
        raise ValueError(f"mag must be ({nb},) {acc_dtype} beside vote, "
                         f"got {mag.dtype} {tuple(mag.shape)}")
    w = w.reshape(())
    if dev == "cpu":
        m2, s2 = mag.reshape(-1, 1), s.reshape(-1, 1)
        if bits is None:
            v, m = ref.sign_vote_accum_ref(vote, m2, p, s2, w)
        else:
            v, m = ref.sign_vote_accum_fp_ref(vote, m2, p, s2, w, bits)
        return v, m.reshape(-1)
    if not mag.is_contiguous():
        raise ValueError("the CUDA kernels need contiguous operands")
    vout, mout = torch.empty_like(vote), torch.empty_like(mag)
    head = (vote.data_ptr(), mag.data_ptr(), p.data_ptr(), s.data_ptr(),
            w.data_ptr(), int(nb))
    mid = () if bits is None else (bits,)
    name = "sign_vote_accum" + ("" if bits is None else "_fp")
    _launch(name, int(nb), vote, *head, *mid, vout.data_ptr(),
            mout.data_ptr(), _stream(vote))
    return vout, mout


def topk_scatter_accum(acc, q, idx, s, w):
    """acc (nb, LANES) f32 with w * (q * s) added at the lanes idx
    (nb, k) uint16 (distinct within a row; the wire's index type, widened
    inside the kernel), q (nb, k) int8 (K8)."""
    if q.dim() != 2 or not 0 < q.shape[1] <= LANES:
        raise ValueError(f"q must be (nb, k) with 0 < k <= {LANES}, got "
                         f"{tuple(q.shape)}")
    k = int(q.shape[1])
    dev = _decode_device(acc, q, s, w, torch.float32, torch.int8, k, 1)
    if idx.dtype != torch.uint16 or idx.shape != q.shape \
            or idx.device != acc.device:
        raise ValueError(f"idx must be uint16 {tuple(q.shape)} beside q, "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    w = w.reshape(())
    if dev == "cpu":
        return ref.topk_scatter_accum_ref(acc, q, idx, s.reshape(-1, 1), w)
    if not idx.is_contiguous() or not _vec_aligned(idx, 2):
        raise ValueError("the CUDA kernels need contiguous, 2-byte aligned "
                         "indices")
    out = torch.empty_like(acc)
    nb = int(acc.shape[0])
    _launch("topk_scatter_accum", nb, acc, acc.data_ptr(), q.data_ptr(),
            idx.data_ptr(), s.data_ptr(), w.data_ptr(), nb, k,
            out.data_ptr(), _stream(acc), k=k)
    return out


# ---- flat encoders and the dequantiser (K12-K16) ----------------------------


def _flat_device(*xs: torch.Tensor) -> str:
    """Validate flat (n,) f32 buffers of one length on one device; returns
    the device type."""
    x0 = xs[0]
    for x in xs:
        if x.dtype != torch.float32 or x.dim() != 1:
            raise TypeError(f"expected 1-D float32 buffers, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.shape != x0.shape or x.device != x0.device:
            raise ValueError("the flat buffers must share one length and "
                             "one device")
    return _devtype(x0.device)


def _flat_rows(x: torch.Tensor) -> torch.Tensor:
    """(n,) -> (ceil(n / LANES), LANES): a view when n is a row multiple
    and the buffer is contiguous and 16-byte aligned, else a zero-padded
    copy."""
    n = x.numel()
    rows = -(-n // LANES)
    if n % LANES == 0 and x.is_contiguous() and _vec_aligned(x, 16):
        return x.view(rows, LANES)
    out = torch.zeros((rows, LANES), dtype=x.dtype, device=x.device)
    out.view(-1)[:n].copy_(x)
    return out


def _empty(rows, cols, dtype, like):
    return torch.empty((rows, cols), dtype=dtype, device=like.device)


def quantize_int8(x):
    """K12: int8 absmax quantise + residual of a flat buffer that already
    carries the error feedback.  Returns (q (R, LANES) int8, scales (R, 1)
    f32, residual (n,), n)."""
    n = x.numel()
    dev = _flat_device(x)
    x2 = _flat_rows(x)
    if dev == "cpu":
        q, s, r = ref.quantize_int8_ref(x2)
        return q, s, r.reshape(-1)[:n], n
    R = x2.shape[0]
    q, s = _empty(R, LANES, torch.int8, x), _empty(R, 1, torch.float32, x)
    r = _empty(R, LANES, torch.float32, x)
    _launch("quantize_int8", R, x, x2.data_ptr(), R, q.data_ptr(),
            s.data_ptr(), r.data_ptr(), _stream(x))
    return q, s, r.reshape(-1)[:n], n


def _ef_flat(name, plain, g, e, gamma, q_cols, q_dtype):
    """Shared body of :func:`ef_int4` and :func:`ef_sign`."""
    n = g.numel()
    dev = _flat_device(g, e)
    g2, e2 = _flat_rows(g), _flat_rows(e)
    if dev == "cpu":
        q, s, r = plain(g2, e2, gamma=gamma)
        return q, s, r.reshape(-1)[:n], n
    R = g2.shape[0]
    q, s = _empty(R, q_cols, q_dtype, g), _empty(R, 1, torch.float32, g)
    r = _empty(R, LANES, torch.float32, g)
    _launch(name, R, g, g2.data_ptr(), e2.data_ptr(), R, float(gamma),
            q.data_ptr(), s.data_ptr(), r.data_ptr(), _stream(g))
    return q, s, r.reshape(-1)[:n], n


def ef_int4(g, e, *, gamma: float):
    """K13: EF + packed-int4 quantise of flat buffers.  Returns (packed
    (R, LANES // 2) uint8, scales (R, 1) f32, residual (n,), n)."""
    return _ef_flat("ef_int4", ref.ef_int4_ref, g, e, gamma, LANES // 2,
                    torch.uint8)


def ef_sign(g, e, *, gamma: float):
    """K14: EF + 1-bit sign of flat buffers.  Returns (sign (R, LANES)
    int8, scales (R, 1) f32, residual (n,), n)."""
    return _ef_flat("ef_sign", ref.ef_sign_ref, g, e, gamma, LANES,
                    torch.int8)


def ef_topk(g, e, *, gamma: float, k: int):
    """K15: EF + block top-k selection of flat buffers.  Returns
    (selected (n,), residual (n,))."""
    if not 0 < k <= LANES:
        raise ValueError(f"k must be in (0, {LANES}], got {k}")
    n = g.numel()
    dev = _flat_device(g, e)
    g2, e2 = _flat_rows(g), _flat_rows(e)
    if dev == "cpu":
        sel, r = ref.ef_topk_select_ref(g2, e2, gamma=gamma, k=k)
    else:
        R = g2.shape[0]
        sel = _empty(R, LANES, torch.float32, g)
        r = _empty(R, LANES, torch.float32, g)
        _launch("ef_topk", R, g, g2.data_ptr(), e2.data_ptr(), R,
                float(gamma), int(k), sel.data_ptr(), r.data_ptr(),
                _stream(g))
    return sel.reshape(-1)[:n], r.reshape(-1)[:n]


def dequant_int8(q, scales, n: int):
    """K16: q (R, LANES) int8 times its row scale (R, 1) f32, flattened
    and sliced to ``n``."""
    R = q.shape[0] if q.dim() == 2 else -1
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != LANES:
        raise ValueError(f"q must be (R, {LANES}) int8, got {q.dtype} "
                         f"{tuple(q.shape)}")
    if scales.dtype != torch.float32 or scales.numel() != R \
            or scales.device != q.device:
        raise ValueError(f"scales must be {R} float32 beside q, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if not 0 <= n <= R * LANES:
        raise ValueError(f"n must be in [0, {R * LANES}], got {n}")
    if _devtype(q.device) == "cpu":
        return ref.dequantize_int8_ref(q, scales.reshape(R, 1)
                                       ).reshape(-1)[:n]
    if q.device.type == "cuda" and not (
            q.is_contiguous() and scales.is_contiguous()
            and _vec_aligned(q, 4) and _vec_aligned(scales, 4)):
        raise ValueError("the CUDA kernels need contiguous, aligned q and "
                         "scales")
    out = _empty(R, LANES, torch.float32, q)
    _launch("dequant_int8", R, q, q.data_ptr(), scales.data_ptr(), R,
            out.data_ptr(), _stream(q))
    return out.reshape(-1)[:n]
