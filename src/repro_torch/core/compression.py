"""Blocked gradient compression operators (paper eqs. 6-7) and the
``Level`` ladder view — the port of ``repro/core/compression.py``.

The wire formats live in :mod:`repro_torch.codecs`; what remains here are
the blocked reference operators (``topk_compress`` / ``int8_compress`` and
their inverses) that the codecs encode and decode with, and
:class:`Level`, a hashable (name, keep_ratio, value_bits) view of one
ladder rung that resolves to its registered codec.

Numerics follow the reference as it runs under ``jit`` on XLA:CPU:
``absmax / 127`` is a multiplication by the f32 reciprocal, ``x / scale``
an IEEE division, ``round`` half to even, and top-k ties go to the lower
index (``jax.lax.top_k``'s order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import INV127, SCALE_FLOOR

BLOCK = 1024


class Level(NamedTuple):
    """One rung of the compression ladder — a thin view over a codec."""
    name: str
    keep_ratio: float       # fraction of entries transmitted (1.0 = all)
    value_bits: int         # 16 (bf16), 8 (int8), 4, 1 (sign), 0 (skip)

    @property
    def is_full(self) -> bool:
        return self.keep_ratio >= 1.0 and self.value_bits >= 16

    @property
    def is_topk(self) -> bool:
        return 0.0 < self.keep_ratio < 1.0

    @property
    def codec(self):
        """The registered codec this rung resolves to (cached)."""
        from repro_torch.codecs import codec_for_level
        return codec_for_level(self)

    def block_k(self, block: int = BLOCK) -> int:
        """Static k per block (dense rungs: the whole block)."""
        if self.is_topk:
            return self.codec.block_k(block)
        return block

    def wire_bytes(self, n: int, n_pods: int, block: int = BLOCK) -> int:
        """Bytes this level moves over the pod axis per device per sync."""
        return self.codec.wire_bytes(n, n_pods, block)


def pad_to_blocks(flat: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    n = flat.shape[0]
    nb = (n + block - 1) // block
    pad = nb * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, block)


def topk_indices(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row, by (value descending,
    index ascending) — ``jax.lax.top_k``'s tie order, which
    ``torch.topk`` does not promise.  A stable descending sort keeps equal
    values in index order."""
    return torch.sort(mag, dim=1, descending=True, stable=True)[1][:, :k]


def topk_compress(blocks: torch.Tensor, k: int):
    """blocks: (nb, B) f32 -> (values int8 (nb, k), idx uint16 (nb, k),
    scales f32 (nb,)).  Values int8-quantised with per-block absmax
    scale."""
    idx = topk_indices(blocks.abs(), k)
    vals = torch.gather(blocks, 1, idx)
    scale = torch.clamp_min(vals.abs().amax(dim=1) * INV127, SCALE_FLOOR)
    q = torch.clamp(torch.round(vals / scale[:, None]), -127, 127)
    return q.to(torch.int8), idx.to(torch.uint16), scale


def topk_decompress(q, idx, scale, block: int = BLOCK):
    """Inverse of :func:`topk_compress` -> dense (nb, B) f32."""
    vals = q.float() * scale[:, None]
    out = torch.zeros((q.shape[0], block), dtype=torch.float32,
                      device=q.device)
    return out.scatter_add_(1, idx.long(), vals)


def int8_compress(blocks: torch.Tensor):
    scale = torch.clamp_min(blocks.abs().amax(dim=1) * INV127, SCALE_FLOOR)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def int8_decompress(q, scale):
    return q.float() * scale[:, None]
