"""Wrappers of the gather + error-feedback encode kernels.

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
the rows every receiver reconstructs, written by the kernel itself.  Every kernel launch adds one to its entry in :data:`LAUNCHES` (and
nothing else does), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

LANES = ref.LANES

KERNELS = ("gather_ef_int8", "gather_ef_int4", "gather_ef_sign",
           "gather_ef_topk")
#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _check(fb: torch.Tensor, eb: torch.Tensor, perm: torch.Tensor) -> str:
    """Validate the buffers; returns the device type ('cpu' or 'cuda')."""
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
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _launch(name: str, *args) -> None:
    """Launch ``name``; ``args[3]`` is the row count S (0: no launch)."""
    if args[3] == 0:
        return
    from repro_torch.kernels import build
    rc = getattr(build.load(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1


def _common(fb, eb, perm, gamma):
    stream = torch.cuda.current_stream(fb.device).cuda_stream
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
    _launch(name, *args, q.data_ptr(), s.data_ptr(), r.data_ptr(),
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
    _launch("gather_ef_topk", fbp, ebp, pp, S_, nbp1, gam, int(k),
            sel.data_ptr(), r.data_ptr(), stream)
    return sel, r.reshape(-1)
