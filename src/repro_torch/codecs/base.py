"""Compression codecs for the sync wire — port of
``repro/codecs/base.py``.

A :class:`Codec` owns one rung of the compression ladder:

  * ``encode`` / ``decode``  — the wire format on blocked gradients;
  * ``ef_encode`` / ``ef_encode_gather`` — error feedback + compression of
    one flat buffer, or of the rung's rows gathered straight out of the
    packed (NB+1, block) grad / error buffers (producer-fused codecs run
    the gather + EF + encode kernels of :mod:`repro_torch.kernels.ops`);
  * ``pod_exchange`` — the one-shot exchange over the pod group: the
    payload packed into ONE uint8 wire, ONE ``all_gather``, and the peer
    payloads folded in canonical pod order through the accumulation trio
    (``accum_init`` / ``decode_accumulate`` / ``accum_finalize``, the
    decode-accumulate kernels K5-K11 on the card).  ``ef_encode_wire`` and
    ``wire_decode_fold`` are its two halves, which ``core/sync.py`` uses
    to send every rung of a backward segment in one collective;
  * ``ef_sync`` / ``ef_sync_gather`` — one sync round.  On one pod the
    aggregate is the codec's own reconstruction weighted by its omega;
    with 3 or more pods the fold is deterministic (int32 fixed point /
    integer votes, or canonical order for ``canonical_fold`` codecs), so
    every pod gets the same bits;
  * ``wire_bytes`` — analytic per-device bytes over the pod axis, the one
    place comm volume is priced (scheduler, knapsack, comm accounting).

  * ``ef_sync_ring`` — the chunked ring: the payload split into K row
    chunks that travel the pod ring hop by hop (two half-rings by
    default), each chunk folded while the next one is on the link.  Its
    aggregate is bit-identical to the one-shot exchange's and on every
    pod: integer folds (P >= 3) are exact in any order, and every float
    fold runs in canonical pod order 0..P-1 — at P = 2 too, where the
    reference folds its own payload first and its two pods can differ in
    the last bit.

  * ``ef_sync_hier`` — the two-tier round on a hierarchical fleet: the
    intra codec's ``ef_sync`` over the cluster, then the cluster
    aggregate re-encoded (no error feedback, unit weights) and exchanged
    over the cross tier, through the ring or one-shot.

Every collective takes a :class:`~repro_torch.launch.mesh.PodGroup`
(``pods``, or ``intra`` / ``cross`` for the two tiers) where the
reference names its mesh axis.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Type

import torch

from repro_torch.core.compression import BLOCK, pad_to_blocks
from repro_torch.kernels.ref import (FIXED_POINT_BITS, ef_accumulate,
                                     fixed_point, fma_f32, from_fixed_point,
                                     ftz)

def _need_pods(pods, n_pods: int):
    if pods is None or pods.size != n_pods:
        raise ValueError(f"the exchange over {n_pods} pods needs their pod "
                         f"group (pods=...), got {pods!r}")


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
    #: True for payload-gather codecs: the rung's wire joins the backward
    #: segment's one coalesced ``all_gather`` (``ef_encode_wire`` +
    #: ``wire_decode_fold``); False for FULL's sum and SKIP's nothing.  In
    #: the reference it also marks the rungs the chunked ring may carry.
    supports_ring: bool = True
    #: True for dense quantisers whose cluster aggregate re-encodes
    #: faithfully without a second error-feedback stage: the rungs the
    #: two-tier exchange carries (``ef_sync_hier``)
    supports_hier: bool = False
    #: True when the accumulate is order-sensitive even in deterministic
    #: mode (top-k's float scatter-add): the fold stays in float, in
    #: canonical pod order 0..P-1, which every pod shares.  False: the
    #: deterministic fold is exact integer arithmetic.
    canonical_fold: bool = False

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

    # ---- the one-shot pod exchange ---------------------------------------
    def pod_exchange(self, payload: Dict[str, torch.Tensor],
                     omega: torch.Tensor, *, n: int, pods,
                     block: int = BLOCK, deterministic: bool = False,
                     fixed_bits: int = FIXED_POINT_BITS) -> torch.Tensor:
        """Aggregate payloads across the pod group -> (n,) f32: the payload
        packed into one uint8 wire, ONE ``all_gather``, then the peer
        decodes folded in canonical pod order (paper eq. 8)."""
        wire, meta = pack_payload(payload)
        gathered = pods.all_gather_bytes(wire)      # (P, payload_bytes)
        return self.wire_decode_fold(gathered, meta, omega, n=n,
                                     block=block,
                                     deterministic=deterministic,
                                     fixed_bits=fixed_bits)

    def ef_encode_wire(self, fb: torch.Tensor, eb: torch.Tensor,
                       perm: torch.Tensor, *, gamma: float,
                       block: int = BLOCK
                       ) -> Tuple[torch.Tensor, tuple, torch.Tensor]:
        """Encode half of :meth:`ef_sync_gather`, stopped at the wire:
        ``(wire, meta, new_e)`` with ``wire`` the packed uint8 payload.
        ``core/sync.py`` concatenates the wires of every payload rung in a
        segment into one ``all_gather``."""
        payload, _own, new_e = self.ef_encode_gather(fb, eb, perm,
                                                     gamma=gamma,
                                                     block=block)
        wire, meta = pack_payload(payload)
        return wire, meta, new_e

    def wire_decode_fold(self, gathered: torch.Tensor, meta: tuple,
                         omega: torch.Tensor, *, n: int, block: int = BLOCK,
                         deterministic: bool = False,
                         fixed_bits: int = FIXED_POINT_BITS
                         ) -> torch.Tensor:
        """Decode half of the one-shot exchange: fold the gathered
        ``(P, payload_bytes)`` wire rows through the accumulation trio in
        canonical pod order -> dense (n,) f32, one peer at a time."""
        # canonical-fold codecs (top-k) are order-deterministic here
        # already: the gather order is the canonical order
        det = deterministic and not self.canonical_fold
        init_kw, fold_kw = self._det_kwargs(det, fixed_bits)
        acc = self.accum_init(n_blocks(n, block), block,
                              device=gathered.device, **init_kw)
        for p in range(gathered.shape[0]):
            acc = self.decode_accumulate(
                acc, unpack_payload(gathered[p], meta), omega[p],
                block=block, **fold_kw)
        return self.accum_finalize(acc, n, block, **fold_kw)

    # ---- the accumulation trio ------------------------------------------
    def accum_init(self, nb: int, block: int = BLOCK, *, device,
                   deterministic: bool = False):
        """Fresh accumulator for ``nb`` blocks on ``device``: the dense f32
        partial sum, or with ``deterministic`` the int32 fixed-point
        one."""
        dtype = torch.int32 if deterministic else torch.float32
        return torch.zeros((nb, block), dtype=dtype, device=device)

    def decode_accumulate(self, acc, payload: Dict[str, torch.Tensor],
                          weight: torch.Tensor, *, block: int = BLOCK,
                          deterministic: bool = False,
                          fixed_bits: int = FIXED_POINT_BITS):
        """``acc + weight * decode(payload)``: one peer folded into the
        running aggregate (``deterministic``: the weighted term in int32
        fixed point).  Codecs with a decode-accumulate kernel override
        this; the default materialises the dense decode."""
        dense = self.decode(payload, block)
        if deterministic:
            return acc + fixed_point(ftz(weight * dense), fixed_bits)
        return fma_f32(weight, dense, acc)

    def accum_finalize(self, acc, n: int, block: int = BLOCK, *,
                       deterministic: bool = False,
                       fixed_bits: int = FIXED_POINT_BITS) -> torch.Tensor:
        """Running aggregate -> dense (n,) f32."""
        if deterministic:
            acc = from_fixed_point(acc, fixed_bits)
        return acc.reshape(-1)[:n]

    @staticmethod
    def _det_kwargs(deterministic: bool,
                    fixed_bits: int) -> Tuple[dict, dict]:
        """(accum_init kwargs, decode_accumulate / accum_finalize kwargs):
        the deterministic ones only when that mode is on."""
        if not deterministic:
            return {}, {}
        return ({"deterministic": True},
                {"deterministic": True, "fixed_bits": fixed_bits})

    # ---- one sync round -------------------------------------------------
    def _exchange(self, payload, own, omega, omega_own, n, *, n_pods, pods,
                  block, deterministic, fixed_bits):
        if n_pods <= 1:
            return own * omega_own
        _need_pods(pods, n_pods)
        if deterministic is None:
            deterministic = n_pods >= 3
        return self.pod_exchange(payload, omega, n=n, pods=pods,
                                 block=block, deterministic=deterministic,
                                 fixed_bits=fixed_bits)

    def ef_sync(self, flat: torch.Tensor, e_flat: torch.Tensor,
                omega: torch.Tensor, omega_own: torch.Tensor, *,
                gamma: float, n_pods: int, block: int = BLOCK, pods=None,
                deterministic: Optional[bool] = None,
                fixed_bits: int = FIXED_POINT_BITS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """EF + compress + exchange one flat buffer -> ``(agg, new_e)``,
        with ``own + new_e == ef``.  ``deterministic`` (auto: on for
        P >= 3) folds the gathered payloads exactly."""
        payload, own, new_e = self.ef_encode(flat, e_flat, gamma=gamma,
                                             block=block)
        agg = self._exchange(payload, own, omega, omega_own, flat.shape[0],
                             n_pods=n_pods, pods=pods, block=block,
                             deterministic=deterministic,
                             fixed_bits=fixed_bits)
        return agg, new_e

    def ef_sync_gather(self, fb: torch.Tensor, eb: torch.Tensor,
                       perm: torch.Tensor, omega: torch.Tensor,
                       omega_own: torch.Tensor, *, gamma: float,
                       n_pods: int, block: int = BLOCK, pods=None,
                       deterministic: Optional[bool] = None,
                       fixed_bits: int = FIXED_POINT_BITS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`ef_sync` of the rung bucket ``fb[perm]``; producer-fused
        codecs run the gather inside the encode kernel."""
        if not self.producer_fused:
            return self.ef_sync(gather_rows(fb, perm).reshape(-1),
                                gather_rows(eb, perm).reshape(-1), omega,
                                omega_own, gamma=gamma, n_pods=n_pods,
                                block=block, pods=pods,
                                deterministic=deterministic,
                                fixed_bits=fixed_bits)
        payload, own, new_e = self.ef_encode_gather(fb, eb, perm,
                                                    gamma=gamma, block=block)
        agg = self._exchange(payload, own, omega, omega_own,
                             perm.shape[0] * block, n_pods=n_pods,
                             pods=pods, block=block,
                             deterministic=deterministic,
                             fixed_bits=fixed_bits)
        return agg, new_e

    # ---- the chunked ring ------------------------------------------------
    def _chunk_payload(self, payload: Dict[str, torch.Tensor], i: int,
                       cb: int) -> Dict[str, torch.Tensor]:
        """Rows ``[i*cb, (i+1)*cb)`` of every payload component (every
        component's leading dimension is the block row)."""
        return {k: a[i * cb:(i + 1) * cb] for k, a in payload.items()}

    def ef_sync_ring(self, flat: torch.Tensor, e_flat: torch.Tensor,
                     omega: torch.Tensor, omega_own: torch.Tensor, *,
                     gamma: float, n_pods: int, n_chunks: int,
                     block: int = BLOCK, pods=None, bidir: bool = True,
                     deterministic: Optional[bool] = None,
                     fixed_bits: int = FIXED_POINT_BITS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """EF + compress + chunked ring exchange of one flat buffer ->
        ``(agg, new_e)``.

        The payload is cut into ``n_chunks`` equal row chunks (the plan
        pads the bucket to a chunk multiple), which travel the pod ring
        with K*(P-1) hops — the all_gather receive volume.  ``bidir``: two
        half-rings, ceil((P-1)/2) hops forward and floor((P-1)/2)
        backward, both directions in flight together.  Hop 0 is the own
        chunk; at each later hop chunk i's transfers are posted before
        chunk i-1's receives are folded, so the fold runs while the link
        carries the next chunk.  The caller's buffers are dropped as soon
        as they are encoded.

        ``deterministic`` (auto: on for P >= 3) folds in exact integer
        arithmetic, in arrival order; every float fold (top-k's
        ``canonical_fold``, and any codec at P = 2) buffers each chunk's P
        payloads and folds them in canonical pod order 0..P-1
        (:meth:`_ring_canonical_fold`).  Either way the aggregate is the
        one-shot exchange's, bit for bit, on every pod."""
        if n_pods <= 1 or not self.supports_ring:
            return self.ef_sync(flat, e_flat, omega, omega_own, gamma=gamma,
                                n_pods=n_pods, block=block, pods=pods,
                                deterministic=deterministic,
                                fixed_bits=fixed_bits)
        _need_pods(pods, n_pods)
        if deterministic is None:
            deterministic = n_pods >= 3
        if n_pods >= 3 and not deterministic:
            raise ValueError(
                f"the float ring fold in arrival order drifts across pods "
                f"for n_pods={n_pods} >= 3; pass deterministic=None or True")
        n = flat.shape[0]
        payload, own, new_e = self.ef_encode(flat, e_flat, gamma=gamma,
                                             block=block)
        del flat, e_flat, own
        nb = n_blocks(n, block)
        K = max(1, min(int(n_chunks), nb))
        if nb % K:
            raise ValueError(f"{nb} blocks do not split into {K} chunks")
        cb = nb // K
        chunks = [self._chunk_payload(payload, i, cb) for i in range(K)]
        wires = [pack_payload(c) for c in chunks]
        meta = wires[0][1]
        wires = [w for w, _ in wires]
        del payload
        P = n_pods
        hops_f = P // 2 if bidir else P - 1
        hops_b = P - 1 - hops_f
        if self.canonical_fold or not deterministic:
            parts = self._ring_canonical_fold(wires, meta, omega, pods,
                                              hops_f, hops_b, cb, block)
        else:
            parts = self._ring_stream_fold(chunks, wires, meta, omega,
                                           omega_own, pods, hops_f, hops_b,
                                           cb, block, fixed_bits)
        agg = parts[0] if K == 1 else torch.cat(parts)
        return agg[:n], new_e

    @staticmethod
    def _ring_walk(wires, pods, hops_f: int, hops_b: int, on_recv) -> None:
        """Drive the hops: at hop h (1..max(hops_f, hops_b)) post chunk i's
        transfers, then call ``on_recv(h, i - 1, recv_f, recv_b)`` with
        chunk i-1's arrivals — forward from pod (my - h) % P, backward from
        (my + h) % P — which the next hop forwards as they are."""
        K = len(wires)
        cur_f = pods.ring_stage(wires)
        cur_b = list(cur_f)
        for h in range(1, max(hops_f, hops_b) + 1):
            nxt_f, nxt_b = [None] * K, [None] * K

            def land(i, hop):
                nxt_f[i], nxt_b[i] = hop.wait()
                on_recv(h, i, nxt_f[i], nxt_b[i])

            pending = None
            for i in range(K):
                hop = pods.ring_hop(cur_f[i] if h <= hops_f else None,
                                    cur_b[i] if h <= hops_b else None,
                                    tag=h * K + i)
                if pending is not None:
                    land(*pending)
                pending = (i, hop)
            land(*pending)
            cur_f, cur_b = nxt_f, nxt_b

    def _ring_stream_fold(self, chunks, wires, meta, omega, omega_own, pods,
                          hops_f, hops_b, cb, block, fixed_bits):
        """Exact integer fold of every arrival as it lands (P >= 3): the
        fixed-point partial sums and integer votes are the same bits in
        any order."""
        init_kw, fold_kw = self._det_kwargs(True, fixed_bits)
        dev = omega.device
        accs = [self.decode_accumulate(
                    self.accum_init(cb, block, device=dev, **init_kw),
                    c, omega_own, block=block, **fold_kw) for c in chunks]
        P, my = pods.size, pods.rank

        def on_recv(h, i, rf, rb):
            for buf, src in ((rf, (my - h) % P), (rb, (my + h) % P)):
                if buf is not None:
                    accs[i] = self.decode_accumulate(
                        accs[i], unpack_payload(pods.ring_to_device(buf),
                                                meta),
                        omega[src], block=block, **fold_kw)

        self._ring_walk(wires, pods, hops_f, hops_b, on_recv)
        return [self.accum_finalize(a, cb * block, block, **fold_kw)
                for a in accs]

    def _ring_canonical_fold(self, wires, meta, omega, pods, hops_f, hops_b,
                             cb, block):
        """Canonical-order float fold: each chunk's arrivals are held
        (in the transport's buffers) until its last hop has landed, then
        its P payloads are folded in pod order 0..P-1 — the association of
        the one-shot exchange's fold, so every pod gets its bits."""
        P, my = pods.size, pods.rank
        held = [{my: w} for w in wires]
        last = max(hops_f, hops_b)
        parts = [None] * len(wires)

        def on_recv(h, i, rf, rb):
            if rf is not None:
                held[i][(my - h) % P] = rf
            if rb is not None:
                held[i][(my + h) % P] = rb
            if h < last:
                return
            acc = self.accum_init(cb, block, device=omega.device)
            for p in range(P):
                wire = held[i][p] if p == my else pods.ring_to_device(
                    held[i][p])
                acc = self.decode_accumulate(acc, unpack_payload(wire, meta),
                                             omega[p], block=block)
            held[i] = None
            parts[i] = self.accum_finalize(acc, cb * block, block)

        self._ring_walk(wires, pods, hops_f, hops_b, on_recv)
        return parts

    # ---- the two-tier round (hierarchical fleets) -------------------------
    def ef_sync_hier(self, flat: torch.Tensor, e_flat: torch.Tensor,
                     omega_intra: torch.Tensor, omega_own: torch.Tensor, *,
                     gamma: float, n_cross: int, n_edge: int,
                     intra_mode: int, n_chunks: int = 0,
                     block: int = BLOCK, cross=None, intra=None,
                     bidir: bool = True,
                     deterministic: Optional[bool] = None,
                     fixed_bits: int = FIXED_POINT_BITS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two-tier EF sync -> ``(agg, new_e)``: the E members of a cluster
        aggregate over ``intra``, and ONE payload per cluster crosses the
        ``cross`` tier, so a member receives (C - 1) payloads there
        instead of (C*E - 1).

        Tier 1 is the intra codec's ``ef_sync`` (FULL's bf16 sum or INT8's
        gather + fold, :data:`~repro_torch.core.planexec.INTRA_FULL` /
        ``INTRA_INT8``) over ``intra`` with the members' weights
        ``omega_intra``; its residual is the member's error feedback.  The
        cluster aggregate is bit-identical on the cluster's members, so
        tier 2 re-encodes it with this codec with ``gamma=0`` (no
        cluster-level error feedback) and exchanges it over ``cross`` with
        unit weights (omega was applied at tier 1): the chunked ring when
        ``n_chunks`` > 0, else one-shot."""
        from repro_torch.core.planexec import INTRA_INT8
        inner = build_codec("int8" if intra_mode == INTRA_INT8 else "full")
        agg_c, new_e = inner.ef_sync(
            flat, e_flat, omega_intra, omega_own, gamma=gamma,
            n_pods=n_edge, block=block, pods=intra,
            deterministic=deterministic, fixed_bits=fixed_bits)
        del flat, e_flat
        zeros = torch.zeros_like(agg_c)
        unit = torch.ones((n_cross,), dtype=torch.float32,
                          device=agg_c.device)
        kw = dict(gamma=0.0, n_pods=n_cross, block=block, pods=cross,
                  deterministic=deterministic, fixed_bits=fixed_bits)
        if n_chunks and self.supports_ring and n_cross > 1:
            agg, _ = self.ef_sync_ring(agg_c, zeros, unit, unit[0],
                                       n_chunks=n_chunks, bidir=bidir, **kw)
        else:
            agg, _ = self.ef_sync(agg_c, zeros, unit, unit[0], **kw)
        return agg, new_e

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


def _plan_sig(plan, sizes, block: int, use_sig: bool = True):
    """The bucket signature a plan's exchange moves: its own padded one
    when it carries one counted in ``block``, else the exact one."""
    from repro_torch.core.planexec import bucket_signature
    sig = getattr(plan, "bucket_sig", None) if use_sig else None
    if sig is not None and getattr(plan, "bucket_block", block) != block:
        sig = None
    if sig is None:
        sig = bucket_signature(plan.level_idx, sizes, len(plan.levels),
                               block)
    return sig


def plan_wire_bytes(plan, sizes, n_pods: int, block: int = BLOCK,
                    use_sig: bool = True,
                    n_cross: Optional[int] = None) -> int:
    """Analytic per-device cross-tier wire bytes for a plan, priced on its
    executed (padded) bucket signature when it carries one.  With a tier
    grid (``plan.hier``) two-tier rungs are priced at ``n_cross``
    clusters; the intra tier is :func:`plan_intra_bytes`."""
    from repro_torch.core.planexec import sig_wire_bytes
    return sig_wire_bytes(_plan_sig(plan, sizes, block, use_sig),
                          plan.levels, n_pods, block,
                          hier=getattr(plan, "hier", None), n_cross=n_cross)


def plan_intra_bytes(plan, sizes, n_edge: int, block: int = BLOCK) -> int:
    """Analytic per-device intra-cluster wire bytes of a plan's two-tier
    rungs (zero for flat plans or one-member clusters)."""
    from repro_torch.core.planexec import sig_intra_bytes
    hier = getattr(plan, "hier", None)
    if not hier or n_edge <= 1:
        return 0
    return sig_intra_bytes(_plan_sig(plan, sizes, block), plan.levels,
                           n_edge, block, hier=hier)
