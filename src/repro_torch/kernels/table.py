"""The kernels' table: for each Hopper kernel of the port, the TPU kernel
it replaces and the bytes it moves (and the f32 operations it does) per
row of ``LANES`` lanes.  ``chip_smoke.py`` reckons each kernel's bound
from it, and a dry run (``analysis/cost.py``) the bytes of each launch
it records (:func:`row_bytes`)."""
from __future__ import annotations

from typing import Optional

LANES = 1024
SOURCE = "src/repro_torch/kernels/csrc/gather_encode.cu"
#: name -> (TPU kernel it replaces, bytes written per row, f32 operations
#: per element of the row body).  int8 / int4 / sign write the encoded row,
#: its scale, the residual and own = ef - residual; top-k writes the
#: selection and the residual.
KERNELS = {
    "gather_ef_int8": ("src/repro/kernels/quantize.py:68", 9220, 10),
    "gather_ef_int4": ("src/repro/kernels/quantize.py:151", 8708, 11),
    "gather_ef_sign": ("src/repro/kernels/sign.py:72", 9220, 8),
    "gather_ef_topk": ("src/repro/kernels/topk_compress.py:159", 8192, 38),
}
#: k of the 25 / 10 / 1 % top-k rungs (the all-rungs step runs all three);
#: the timed call uses the 10 % rung's
TOPK_KS = (256, 104, 16)
TOPK_K = 104
DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_accum.cu"
#: decode-accumulate kernel -> (TPU kernel it replaces, bytes per row:
#: the accumulator read and written, the payload row and its scale)
DECODE = {
    "decode_accum_int8": ("src/repro/kernels/decode.py:100", 9220),
    "decode_accum_int4": ("src/repro/kernels/decode.py:122", 8708),
    "sign_vote_accum": ("src/repro/kernels/decode.py:146", 8332),
    "topk_scatter_accum": ("src/repro/kernels/decode.py:256",
                           8192 + 3 * TOPK_K + 4),
    "decode_accum_int8_fp": ("src/repro/kernels/decode.py:185", 9220),
    "decode_accum_int4_fp": ("src/repro/kernels/decode.py:209", 8708),
    "sign_vote_accum_fp": ("src/repro/kernels/decode.py:236", 8332),
}
#: flat encoder / dequantiser (K12-K16) -> (TPU kernel it replaces, bytes
#: per row: each input read once, each output written once, f32
#: operations per element of the row body)
FLAT = {
    "quantize_int8": ("src/repro/kernels/quantize.py:44", 9220, 9),
    "ef_int4": ("src/repro/kernels/quantize.py:126", 12804, 11),
    "ef_sign": ("src/repro/kernels/sign.py:47", 13316, 8),
    "ef_topk": ("src/repro/kernels/topk_compress.py:139", 16384, 38),
    "dequant_int8": ("src/repro/kernels/quantize.py:174", 5124, 1),
}


def row_bytes(name: str, k: Optional[int] = None) -> int:
    """The bytes kernel ``name`` moves per row: a gather encoder reads its
    grad and error rows and their perm entry (2 * LANES * 4 + 4) and
    writes the table's bytes; the others move the table's bytes, top-k's
    scatter-accumulate at its own ``k`` (the table's is at ``TOPK_K``)."""
    if name in KERNELS:
        return 2 * LANES * 4 + 4 + KERNELS[name][1]
    if name == "topk_scatter_accum" and k is not None:
        return 8192 + 3 * int(k) + 4
    if name in DECODE:
        return DECODE[name][1]
    return FLAT[name][1]
