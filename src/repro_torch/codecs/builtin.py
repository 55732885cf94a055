"""The built-in wire-format codecs — port of ``repro/codecs/builtin.py``.

FULL (bf16), dense INT8, packed INT4, block TOPK (int8 values + uint16
indices), 1-bit SIGN with a per-block mean-magnitude scale, and SKIP.
INT8 / INT4 / SIGN / TOPK are producer-fused: their ``ef_encode_gather``
runs the gather + error-feedback + encode kernel of
:mod:`repro_torch.kernels.ops` on the rung's rows, which launches the
Hopper kernel for CUDA tensors and the plain PyTorch version for CPU ones.
The kernels encode rows of ``ops.LANES`` (1024) entries only, so these
codecs refuse any other block size instead of taking a plain path.
"""
from __future__ import annotations

import torch

from repro_torch.codecs.base import (Codec, n_blocks, pack_bits,
                                     register_codec, unpack_bits)
from repro_torch.core.compression import (BLOCK, int8_compress,
                                          int8_decompress, topk_compress,
                                          topk_decompress)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (_int4_body, ef_accumulate, ftz,
                                     pack_nibbles, row_abs_sum,
                                     unpack_nibbles, INV_LANES)


def _kernel_rows(block: int) -> None:
    if block != ops.LANES:
        raise NotImplementedError(
            f"the gather + EF encode kernels work on rows of {ops.LANES} "
            f"entries; block {block} (ACESyncConfig.topk_block) is not "
            f"supported")


@register_codec
class FullCodec(Codec):
    """Dense bf16 — the psum rung.  Wire bytes are the bf16 ring
    all-reduce volume."""
    name = "full"
    value_bits = 16

    def wire_bytes(self, n: int, n_pods: int, block: int = BLOCK) -> int:
        if n_pods <= 1 or n <= 0:
            return 0
        # bf16 ring all-reduce: 2 * (P-1)/P * 2n bytes on the wire
        return int(2 * (n_pods - 1) / n_pods * 2 * n)

    def payload_bytes(self, n: int, block: int = BLOCK) -> int:
        return 2 * n

    def encode(self, blocks):
        return {"wire": blocks.to(torch.bfloat16)}

    def decode(self, payload, block: int = BLOCK):
        return payload["wire"].float()

    def ef_encode(self, flat, e_flat, *, gamma, block=BLOCK):
        ef = ef_accumulate(flat, e_flat, gamma)
        wire = ef.to(torch.bfloat16)
        own = wire.float()
        return {"wire": wire}, own, ftz(ef - own)


@register_codec
class Int8Codec(Codec):
    """Dense blockwise-absmax int8 (+ f32 scale per 1024-block)."""
    name = "int8"
    value_bits = 8
    producer_fused = True

    def payload_bytes(self, n: int, block: int = BLOCK) -> int:
        nb = n_blocks(n, block)
        return nb * block + 4 * nb

    def value_fraction(self) -> float:
        return 0.97

    def encode(self, blocks):
        q, scale = int8_compress(blocks)
        return {"q": q, "scale": scale}

    def decode(self, payload, block: int = BLOCK):
        return int8_decompress(payload["q"], payload["scale"])

    def ef_encode_gather(self, fb, eb, perm, *, gamma, block=BLOCK):
        _kernel_rows(block)
        q, s, r, own = ops.gather_ef_int8(fb, eb, perm, gamma=gamma)
        return {"q": q, "scale": s[:, 0]}, own, r


@register_codec
class TopKCodec(Codec):
    """Block-local top-k, int8-quantised values + uint16 indices."""
    name = "topk"
    value_bits = 8
    producer_fused = True

    def __init__(self, ratio: float = 0.1):
        if not 0.0 < ratio < 1.0:
            raise ValueError(f"topk ratio must be in (0, 1), got {ratio}")
        self.keep_ratio = float(ratio)

    def block_k(self, block: int = BLOCK) -> int:
        """Static k per block (multiple of 8 lanes, >= 8)."""
        k = int(round(self.keep_ratio * block))
        return max(8, ((k + 7) // 8) * 8)

    def payload_bytes(self, n: int, block: int = BLOCK) -> int:
        nb = n_blocks(n, block)
        k = self.block_k(block)
        return nb * k * (1 + 2) + 4 * nb  # int8 vals + u16 idx + f32 scales

    def value_fraction(self) -> float:
        return self.keep_ratio ** 0.5 * 0.97

    def encode(self, blocks):
        q, idx, scale = topk_compress(blocks, self.block_k(blocks.shape[1]))
        return {"q": q, "idx": idx, "scale": scale}

    def decode(self, payload, block: int = BLOCK):
        return topk_decompress(payload["q"], payload["idx"],
                               payload["scale"], block)

    def ef_encode_gather(self, fb, eb, perm, *, gamma, block=BLOCK):
        _kernel_rows(block)
        n = perm.shape[0] * block
        sel, res = ops.gather_ef_topk(fb, eb, perm, gamma=gamma,
                                      k=self.block_k(block))
        payload = self.encode(sel)          # sel is already (S, block)
        own = self.decode(payload, block).reshape(-1)[:n]
        # the residual picks up the dropped entries (res) and the int8
        # quantisation error of the kept ones (sel - own)
        return payload, own, ftz(ftz(sel.reshape(-1) - own) + res)


@register_codec
class SkipCodec(Codec):
    """Transmit nothing; the whole EF accumulator becomes the residual."""
    name = "skip"
    value_bits = 0
    keep_ratio = 0.0

    def payload_bytes(self, n: int, block: int = BLOCK) -> int:
        return 0

    def wire_bytes(self, n: int, n_pods: int, block: int = BLOCK) -> int:
        return 0

    def value_fraction(self) -> float:
        return 0.0

    def encode(self, blocks):
        return {}

    def decode(self, payload, block: int = BLOCK):
        raise NotImplementedError("SKIP has no payload to decode")

    def ef_sync(self, flat, e_flat, omega, omega_own, *, gamma, n_pods,
                block=BLOCK, **_kw):
        ef = ef_accumulate(flat, e_flat, gamma)
        return torch.zeros_like(flat), ef


@register_codec
class Int4Codec(Codec):
    """Dense packed int4: two nibbles per byte + blockwise absmax scale."""
    name = "int4"
    value_bits = 4
    producer_fused = True

    def payload_bytes(self, n: int, block: int = BLOCK) -> int:
        nb = n_blocks(n, block)
        return nb * (block // 2) + 4 * nb

    def value_fraction(self) -> float:
        return 0.90

    def encode(self, blocks):
        q, scale = _int4_body(blocks)
        return {"q": pack_nibbles(q), "scale": scale[:, 0]}

    def decode(self, payload, block: int = BLOCK):
        return unpack_nibbles(payload["q"]) * payload["scale"][:, None]

    def ef_encode_gather(self, fb, eb, perm, *, gamma, block=BLOCK):
        _kernel_rows(block)
        p, s, r, own = ops.gather_ef_int4(fb, eb, perm, gamma=gamma)
        return {"q": p, "scale": s[:, 0]}, own, r


@register_codec
class SignCodec(Codec):
    """1-bit sign + per-block mean-|ef| scale, majority-vote aggregation
    (the vote is the multi-pod slice's)."""
    name = "sign"
    value_bits = 1
    producer_fused = True

    def payload_bytes(self, n: int, block: int = BLOCK) -> int:
        nb = n_blocks(n, block)
        return nb * (block // 8) + 4 * nb

    def value_fraction(self) -> float:
        return 0.25

    def encode(self, blocks):
        # mean |x| in the sign kernel's fixed summation order
        scale = ftz(row_abs_sum(blocks)[:, 0] * INV_LANES)
        return {"q": pack_bits(blocks >= 0), "scale": scale}

    def decode(self, payload, block: int = BLOCK):
        signs = unpack_bits(payload["q"], block).float() * 2 - 1
        return signs * payload["scale"][:, None]

    def ef_encode_gather(self, fb, eb, perm, *, gamma, block=BLOCK):
        _kernel_rows(block)
        sg, s, r, own = ops.gather_ef_sign(fb, eb, perm, gamma=gamma)
        return {"q": pack_bits(sg > 0), "scale": s[:, 0]}, own, r
