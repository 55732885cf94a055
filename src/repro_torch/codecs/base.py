"""Compression codecs for the sync wire — the single-pod contract of the
port of ``repro/codecs/base.py``.

A :class:`Codec` owns one rung of the compression ladder:

  * ``encode`` / ``decode``  — the wire format on blocked gradients;
  * ``ef_encode`` / ``ef_encode_gather`` — error feedback + compression of
    one flat buffer, or of the rung's rows gathered straight out of the
    packed (NB+1, block) grad / error buffers (producer-fused codecs run
    the gather + EF + encode kernels of :mod:`repro_torch.kernels.ops`);
  * ``ef_sync`` / ``ef_sync_gather`` — one sync round.  On one pod the
    aggregate is the codec's own reconstruction weighted by its omega;
  * ``wire_bytes`` — analytic per-device bytes over the pod axis, the one
    place comm volume is priced (scheduler, knapsack, comm accounting).

The multi-pod exchange (``pod_exchange``, ``wire_decode_fold``,
``decode_accumulate``, ``ef_sync_ring``, ``ef_sync_hier``) belongs to the
multi-pod slice of the port and raises ``NotImplementedError`` here.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple, Type

import torch

from repro_torch.core.compression import BLOCK, pad_to_blocks
from repro_torch.kernels.ref import ef_accumulate, ftz

_MULTI_POD = ("the multi-pod exchange is not ported yet: it comes with the "
              "multi-pod slice of repro_torch (one pod only for now)")


# ---------------------------------------------------------------------------
# payload packing: one uint8 wire buffer per codec
# ---------------------------------------------------------------------------


def pack_payload(payload: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, tuple]:
    """Byte views of the payload components, concatenated in sorted key
    order into one flat uint8 buffer — byte for byte the reference's
    wire.  ``meta`` is what :func:`unpack_payload` needs to invert it."""
    parts, meta = [], []
    for key in sorted(payload):
        a = payload[key].contiguous()
        parts.append(a.view(torch.uint8).reshape(-1))
        meta.append((key, tuple(a.shape), a.dtype))
    if not parts:
        return torch.zeros((0,), dtype=torch.uint8), tuple(meta)
    wire = parts[0] if len(parts) == 1 else torch.cat(parts)
    return wire, tuple(meta)


def unpack_payload(wire: torch.Tensor, meta: tuple
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_payload`."""
    out, off = {}, 0
    for key, shape, dtype in meta:
        elems = math.prod(shape) if shape else 1
        nbytes = elems * dtype.itemsize
        out[key] = wire[off:off + nbytes].view(dtype).reshape(shape)
        off += nbytes
    return out


def pack_bits(bools: torch.Tensor) -> torch.Tensor:
    """(rows, C) boolean -> (rows, C // 8) uint8, bit i = column 8r+i."""
    rows, c = bools.shape
    b = bools.reshape(rows, c // 8, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bools.device)
    return (b << shifts).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> (rows, c) {0, 1} uint8."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], c)


def n_blocks(n: int, block: int = BLOCK) -> int:
    return (n + block - 1) // block


def gather_rows(buf: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return buf.index_select(0, perm)


# ---------------------------------------------------------------------------
# the Codec contract
# ---------------------------------------------------------------------------


class Codec:
    """One wire format: compression math + aggregation + accounting."""

    #: registry key; subclasses must override.
    name: str = ""
    #: bits per transmitted value (accounting/ladder ordering only).
    value_bits: int = 16
    #: fraction of entries transmitted (1.0 = dense).
    keep_ratio: float = 1.0
    #: whether ``ef_encode_gather`` runs the fused gather + EF + encode
    #: kernel instead of materialising ``fb[perm]`` first.
    producer_fused: bool = False

    # ---- accounting -----------------------------------------------------
    def payload_bytes(self, n: int, block: int = BLOCK) -> int:
        """Per-device payload size put on the wire (== the packed uint8
        buffer size from :func:`pack_payload`)."""
        raise NotImplementedError

    def wire_bytes(self, n: int, n_pods: int, block: int = BLOCK) -> int:
        """Per-device per-sync bytes over the pod axis: the all_gather
        receive volume — each device receives every peer's payload once."""
        if n_pods <= 1 or n <= 0:
            return 0
        return self.payload_bytes(n, block) * (n_pods - 1)

    def value_fraction(self) -> float:
        """Knapsack value heuristic (only needs to ORDER the ladder)."""
        return 1.0

    # ---- wire format ----------------------------------------------------
    def encode(self, blocks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(nb, block) f32 -> payload dict of tensors."""
        raise NotImplementedError

    def decode(self, payload: Dict[str, torch.Tensor],
               block: int = BLOCK) -> torch.Tensor:
        """payload -> dense (nb, block) f32 (receiver reconstruction)."""
        raise NotImplementedError

    # ---- error feedback + compression -----------------------------------
    def ef_encode(self, flat: torch.Tensor, e_flat: torch.Tensor, *,
                  gamma: float, block: int = BLOCK
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                             torch.Tensor]:
        """Error feedback + compress one flat (n,) f32 buffer.  Returns
        ``(payload, own, new_e)``: ``own = decode(payload)[:n]`` is what
        every receiver reconstructs, ``new_e = ef - own`` the next
        residual."""
        n = flat.shape[0]
        ef = ef_accumulate(flat, e_flat, gamma)
        payload = self.encode(pad_to_blocks(ef, block))
        own = self.decode(payload, block).reshape(-1)[:n]
        return payload, own, ftz(ef - own)

    def ef_encode_gather(self, fb: torch.Tensor, eb: torch.Tensor,
                         perm: torch.Tensor, *, gamma: float,
                         block: int = BLOCK
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                    torch.Tensor]:
        """:meth:`ef_encode` of the rung bucket ``fb[perm]``.  The default
        materialises the gather; producer-fused codecs override it with
        the fused kernel."""
        return self.ef_encode(gather_rows(fb, perm).reshape(-1),
                              gather_rows(eb, perm).reshape(-1),
                              gamma=gamma, block=block)

    # ---- one sync round -------------------------------------------------
    def ef_sync(self, flat: torch.Tensor, e_flat: torch.Tensor,
                omega: torch.Tensor, omega_own: torch.Tensor, *,
                gamma: float, n_pods: int, block: int = BLOCK,
                **_kw) -> Tuple[torch.Tensor, torch.Tensor]:
        """EF + compress + aggregate one flat buffer -> ``(agg, new_e)``,
        with ``own + new_e == ef``."""
        if n_pods > 1:
            raise NotImplementedError(_MULTI_POD)
        payload, own, new_e = self.ef_encode(flat, e_flat, gamma=gamma,
                                             block=block)
        return own * omega_own, new_e

    def ef_sync_gather(self, fb: torch.Tensor, eb: torch.Tensor,
                       perm: torch.Tensor, omega: torch.Tensor,
                       omega_own: torch.Tensor, *, gamma: float,
                       n_pods: int, block: int = BLOCK, **kw
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`ef_sync` of the rung bucket ``fb[perm]``; producer-fused
        codecs run the gather inside the encode kernel."""
        if not self.producer_fused:
            return self.ef_sync(gather_rows(fb, perm).reshape(-1),
                                gather_rows(eb, perm).reshape(-1), omega,
                                omega_own, gamma=gamma, n_pods=n_pods,
                                block=block, **kw)
        if n_pods > 1:
            raise NotImplementedError(_MULTI_POD)
        payload, own, new_e = self.ef_encode_gather(fb, eb, perm,
                                                    gamma=gamma, block=block)
        return own * omega_own, new_e

    # ---- the multi-pod exchange (next slice) ----------------------------
    def pod_exchange(self, *args, **kwargs):
        raise NotImplementedError(_MULTI_POD)

    def wire_decode_fold(self, *args, **kwargs):
        raise NotImplementedError(_MULTI_POD)

    def decode_accumulate(self, *args, **kwargs):
        raise NotImplementedError(_MULTI_POD)

    def ef_sync_ring(self, *args, **kwargs):
        raise NotImplementedError(_MULTI_POD)

    def ef_sync_hier(self, *args, **kwargs):
        raise NotImplementedError(
            "the two-tier exchange is not ported yet: it comes with the "
            "two-tier slice of repro_torch")

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Codec]] = {}


def register_codec(cls: Type[Codec]) -> Type[Codec]:
    """Class decorator: make ``cls`` resolvable by its ``name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if _REGISTRY.get(cls.name) not in (None, cls):
        raise ValueError(f"codec {cls.name!r} already registered by "
                         f"{_REGISTRY[cls.name].__name__}")
    _REGISTRY[cls.name] = cls
    return cls


def list_codecs() -> List[str]:
    return sorted(_REGISTRY)


def get_codec(name: str) -> Type[Codec]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; registered: "
                       f"{list_codecs()}") from None


def build_codec(name: str, **kwargs) -> Codec:
    return get_codec(name)(**kwargs)


_CODEC_CACHE: Dict[Tuple[float, int], Codec] = {}


def codec_for_level(level) -> Codec:
    """Resolve a ``Level(name, keep_ratio, value_bits)`` to its codec
    instance (cached — codecs are stateless)."""
    key = (float(level.keep_ratio), int(level.value_bits))
    codec = _CODEC_CACHE.get(key)
    if codec is None:
        ratio, bits = key
        if ratio <= 0.0:
            codec = build_codec("skip")
        elif ratio < 1.0:
            codec = build_codec("topk", ratio=ratio)
        elif bits >= 16:
            codec = build_codec("full")
        elif bits >= 8:
            codec = build_codec("int8")
        elif bits >= 4:
            codec = build_codec("int4")
        else:
            codec = build_codec("sign")
        _CODEC_CACHE[key] = codec
    return codec


# ---------------------------------------------------------------------------
# plan pricing
# ---------------------------------------------------------------------------


def plan_wire_bytes(plan, sizes, n_pods: int, block: int = BLOCK,
                    use_sig: bool = True) -> int:
    """Analytic per-device wire bytes for a plan, priced on its executed
    (padded) bucket signature when it carries one."""
    from repro_torch.core.planexec import bucket_signature, sig_wire_bytes
    sig = getattr(plan, "bucket_sig", None) if use_sig else None
    if sig is not None and getattr(plan, "bucket_block", block) != block:
        sig = None
    if sig is None:
        sig = bucket_signature(plan.level_idx, sizes, len(plan.levels),
                               block)
    return sig_wire_bytes(sig, plan.levels, n_pods, block)
