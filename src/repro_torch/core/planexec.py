"""Plan-as-data: the executable form of a SyncPlan — port of
``repro/core/planexec.py``.

Every parameter group is laid out block-aligned in one static flat
(NB, block) buffer (:func:`leaf_layout`).  Per ladder rung, a gather
permutation ``perm_r: int32[S_r]`` of block indices repacks the member
groups into one contiguous per-rung buffer; the tuple of padded per-rung
block counts is the **bucket signature**.  Rung sizes of adaptive plans
are rounded up to the reference's scheduled size classes, so the port's
plans, perms and priced bytes are the reference's, index for index.

The JAX package keeps only the signature static so that replans never
recompile; PyTorch runs eagerly, so here the signature matters only for
pricing and for lining the plans up with the reference.

Chunk grid (the ring exchange): rungs big enough to be bound by the pod
link run the chunked ring (``Codec.ef_sync_ring``), K chunks per rung
from :func:`ring_chunk_count`, the reference's roofline heuristic over
this machine's own constants (the H100's memory rate, and the rate and
per-hop latency of the pod link as the port's transport measured them);
a ringing rung's padded size is rounded up to a K multiple.  The grid is
a function of the signature and these module constants alone, never of
anything measured at run time, so every pod computes the same grid.
``chunks[r] == 0`` is the one-shot ``all_gather``.

Tier grid (the two-tier hierarchy): on a fleet of C clusters x E members
every hier-capable rung (INT8, INT4) goes two-tier — intra-cluster
aggregation feeding one payload per cluster over the cross tier
(``Codec.ef_sync_hier``) — and :func:`hier_rung_mode` picks its intra
stage (bf16 sum or INT8 gather) from the intra and cross link rates;
two-tier rungs ring over the C clusters, flat rungs go one-shot over the
whole fleet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.compression import BLOCK, Level

#: default geometric growth of the padded-size ladder (see the reference)
PAD_GROWTH = 1.125
#: floor of the scheduled pad growth
MIN_RUNG_GROWTH = 1.03125
#: rung size (blocks) where the growth schedule starts decaying
RUNG_GROWTH_KNEE = 32


def n_blocks(n: int, block: int = BLOCK) -> int:
    return (int(n) + block - 1) // block


def rung_growth(nb: int, base: Optional[float]) -> Optional[float]:
    """Per-rung pad-growth schedule: power-of-two classes up to 4 blocks,
    the base growth up to the knee, then decaying to MIN_RUNG_GROWTH."""
    if not base or base <= 1.0:
        return base
    if nb <= 4:
        return max(base, 2.0)
    if nb <= RUNG_GROWTH_KNEE:
        return base
    return max(1.0 + (base - 1.0) * (RUNG_GROWTH_KNEE / nb),
               min(base, MIN_RUNG_GROWTH))


def scheduled_block_class(nb: int, base: Optional[float]) -> int:
    """Smallest size class >= ``nb`` on the single scheduled ladder."""
    if nb <= 0:
        return 0
    if not base or base <= 1.0:
        return int(nb)
    c = 1
    while c < nb:
        g = rung_growth(c, base)
        c = max(c + 1, int(math.ceil(c * g)))
    return c


def bucket_signature(level_idx: Sequence[int], sizes: Sequence[int],
                     n_levels: int, block: int = BLOCK,
                     growth: Optional[float] = None) -> Tuple[int, ...]:
    """Padded per-rung block counts (``growth=None``: exact sizes)."""
    per = [0] * n_levels
    for li, n in zip(level_idx, sizes):
        per[int(li)] += n_blocks(n, block)
    if growth:
        per = [scheduled_block_class(nb, growth) for nb in per]
    return tuple(per)


# ---- ring constants: one NVIDIA H100 80GB HBM3 at a 700 W power limit,
# pods as processes sharing the card ------------------------------------
#
# The link constants were measured by ``python -m
# repro_torch.launch.linkbench --iters 20`` (PERF.md): a ping-pong
# between two pod processes over the port's transport for that layout
# (gloo over loopback TCP, each message staged device -> pinned host ->
# device), 4 KB to 64 MB; the median of three runs.  Every pod reads these
# same constants, so the grid never depends on a run's own timing.

#: device memory rate, bytes/s (H100 SXM datasheet, 3.35 TB/s)
HBM_BW = 3.35e12
#: pod-link rate, bytes/s: the slope of the ping-pong's one-way time
#: (runs: 2.409e9, 2.462e9, 1.946e9)
LINK_BW = 2.409e9
#: per-hop latency of the pod link, seconds: the fit's one-way time at
#: zero bytes (runs: 4.313e-4, 3.828e-4, 4.282e-4)
RING_HOP_LATENCY_S = 4.282e-4
#: intra-cluster link rate, bytes/s, of the two-tier hierarchy: the slope
#: of the same ping-pong over cluster 0's 2-member ``intra`` sub-group of
#: a 2 x 2 fleet sharing the card (``linkbench --edge 2 --iters 20``; runs:
#: 1.611e9, 1.441e9, 1.615e9; the plain pair read 2.028e9 in the same
#: call); ``LINK_BW`` is the cross tier's rate
INTRA_BW = 1.611e9
#: never split a rung into more chunks than this (a design constant)
RING_MAX_CHUNKS = 16
#: target link time of one chunk-hop: ~50x the hop latency, which it
#: amortises, as the reference's rule sets it
RING_TARGET_CHUNK_S = 50 * RING_HOP_LATENCY_S


def ring_hops(n_pods: int, bidir: bool = True) -> int:
    """Sequential hops on the ring's critical path: the bidirectional
    ring runs two half-rings, forward ceil((P-1)/2) hops and backward
    floor((P-1)/2)."""
    if n_pods <= 1:
        return 0
    return (n_pods // 2) if bidir else (n_pods - 1)


def ring_chunk_count(level: Level, nb: int, n_pods: int,
                     block: int = BLOCK, ring: Optional[int] = None,
                     bidir: bool = True) -> int:
    """Chunk count K for one rung (0 = the one-shot ``all_gather``).

    The reference's roofline heuristic: the ring hides the per-chunk
    decode (bound by :data:`HBM_BW`) behind the link transfer of the next
    chunk (:data:`LINK_BW`) at the cost of K*(P-1) hops.  A rung rings
    when the decode it could hide outweighs the latency of a 2-chunk ring
    and its per-hop link time is at least 8 hop latencies; K targets
    :data:`RING_TARGET_CHUNK_S` of link time per chunk-hop, clamped to
    [2, RING_MAX_CHUNKS] and rounded up to a power of two.

    ``ring``: None = the heuristic; <= 0 = one-shot; K > 0 = K chunks on
    every ring-capable rung."""
    codec = level.codec
    if (n_pods <= 1 or nb <= 0
            or not getattr(codec, "supports_ring", False)):
        return 0
    if ring is not None:
        return 0 if ring <= 0 else min(int(ring), nb)
    payload = codec.payload_bytes(nb * block, block)
    hops = ring_hops(n_pods, bidir)
    hop_t = payload / LINK_BW
    decode_t = (payload + 8.0 * nb * block) * (n_pods - 1) / HBM_BW
    if decode_t < 2 * hops * RING_HOP_LATENCY_S:
        return 0
    if hop_t < 8 * RING_HOP_LATENCY_S:
        return 0
    k = int(round(hop_t / RING_TARGET_CHUNK_S))
    k = max(2, min(RING_MAX_CHUNKS, nb, k))
    k = 1 << (k - 1).bit_length()
    return min(k, RING_MAX_CHUNKS, nb)


def ring_override(ring_chunks: int) -> Optional[int]:
    """Translate ``ACESyncConfig.ring_chunks`` (0 = auto, -1 = never,
    K = force K) into the ``ring`` argument of :func:`exec_grid` (None =
    auto, <= 0 = one-shot, K = force K)."""
    return None if ring_chunks == 0 else int(ring_chunks)


# ---------------------------------------------------------------------------
# two-tier (hierarchical) exchange: per-rung tier choice
# ---------------------------------------------------------------------------

#: tier grid entries: 0 = flat exchange; 1 = two-tier with a bf16-sum
#: intra-cluster stage; 2 = two-tier with an INT8 gather + fold intra stage
INTRA_FULL = 1
INTRA_INT8 = 2


def hier_override(hier_mode_cfg: int) -> Optional[int]:
    """Translate ``ACESyncConfig.hier_mode`` (0 = roofline auto, -1 =
    never two-tier, 1/2 = force the bf16 / INT8 intra stage) into the
    ``hier`` argument of :func:`hier_rung_mode` / :func:`exec_grid` (None
    = auto, <= 0 = flat, 1/2 = force)."""
    return None if hier_mode_cfg == 0 else int(hier_mode_cfg)


def hier_rung_mode(level: Level, nb: int, n_cross: int, n_edge: int,
                   block: int = BLOCK, hier: Optional[int] = None) -> int:
    """Tier choice for one rung on a (n_cross clusters) x (n_edge members)
    fleet: 0 = flat, :data:`INTRA_FULL` / :data:`INTRA_INT8` = two-tier.

    A hier-capable rung (``codec.supports_hier``) always goes two-tier on
    a hierarchical fleet: its cross-tier volume drops from (C*E - 1) to
    (C - 1) payloads per member.  The roofline picks only the intra
    stage: the bf16 sum while its time on the intra link (``INTRA_BW``)
    stays within the cross tier's transfer (``LINK_BW``), else the INT8
    gather + fold.  A function of (signature, module constants) alone, so
    every member computes the same grid.

    ``hier``: None = the heuristic; <= 0 = flat; 1/2 = force the bf16 /
    INT8 intra stage on every hier-capable rung."""
    codec = level.codec
    if (n_edge <= 1 or n_cross <= 1 or nb <= 0
            or not getattr(codec, "supports_hier", False)):
        return 0
    if hier is not None:
        if hier <= 0:
            return 0
        return INTRA_INT8 if hier >= 2 else INTRA_FULL
    from repro_torch.codecs import build_codec
    n = nb * block
    cross_t = (n_cross - 1) * codec.payload_bytes(n, block) / LINK_BW
    intra_full_t = build_codec("full").wire_bytes(n, n_edge, block) / INTRA_BW
    return INTRA_FULL if intra_full_t <= cross_t else INTRA_INT8


def exec_grid(level_idx: Sequence[int], sizes: Sequence[int],
              levels: Sequence[Level], n_pods: int, block: int = BLOCK,
              growth: Optional[float] = None, ring: Optional[int] = None,
              bidir: bool = True, n_edge: int = 1,
              hier: Optional[int] = None
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """(sig, chunks, hier) of the executed exchange: the class-padded
    signature with each ringing rung rounded up to a chunk multiple, the
    chunk grid (:func:`ring_chunk_count`) and the tier grid
    (:func:`hier_rung_mode`).

    ``n_pods`` is the fleet size; ``n_edge`` > 1 makes it a hierarchical
    fleet of ``n_pods // n_edge`` clusters.  Two-tier rungs ring over the
    clusters; flat rungs on a hierarchical fleet gather over the whole
    fleet in one shot and never ring."""
    sig = list(bucket_signature(level_idx, sizes, len(levels), block,
                                growth))
    n_edge = max(int(n_edge), 1)
    n_cross = max(n_pods // n_edge, 1)
    chunks, hgrid = [], []
    for r, nb in enumerate(sig):
        h = hier_rung_mode(levels[r], nb, n_cross, n_edge, block, hier)
        if h:
            k = ring_chunk_count(levels[r], nb, n_cross, block, ring, bidir)
        elif n_edge > 1:
            k = 0
        else:
            k = ring_chunk_count(levels[r], nb, n_pods, block, ring, bidir)
        if k > 1 and nb % k:
            sig[r] = ((nb + k - 1) // k) * k
        chunks.append(k)
        hgrid.append(h)
    return tuple(sig), tuple(chunks), tuple(hgrid)


def sig_wire_bytes(sig: Sequence[int], levels: Sequence[Level],
                   n_pods: int, block: int = BLOCK,
                   hier: Optional[Sequence[int]] = None,
                   n_cross: Optional[int] = None) -> int:
    """Per-device cross-tier wire bytes of an exchange with bucket
    signature ``sig`` (padding included).  With a tier grid ``hier``,
    two-tier rungs cross the slow tier once per cluster: they are priced
    at ``n_cross`` members instead of ``n_pods``."""
    total = 0
    for r, S in enumerate(sig):
        if not S:
            continue
        pods = n_pods
        if hier and r < len(hier) and hier[r] and n_cross:
            pods = n_cross
        total += levels[r].wire_bytes(S * block, pods, block)
    return int(total)


def sig_intra_bytes(sig: Sequence[int], levels: Sequence[Level],
                    n_edge: int, block: int = BLOCK,
                    hier: Optional[Sequence[int]] = None) -> int:
    """Intra-cluster per-device wire bytes of a hierarchical exchange: each
    two-tier rung's tier-1 volume, priced by the intra codec its tier grid
    entry selects (bf16 sum or INT8 gather).  Flat rungs move nothing on
    the intra tier."""
    if not hier or n_edge <= 1:
        return 0
    from repro_torch.codecs import build_codec
    total = 0
    for r, S in enumerate(sig):
        if not S or not (r < len(hier) and hier[r]):
            continue
        name = "full" if hier[r] == INTRA_FULL else "int8"
        total += build_codec(name).wire_bytes(S * block, n_edge, block)
    return int(total)


# ---------------------------------------------------------------------------
# leaf layout and backward segmentation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafLayout:
    """Where each leaf lands in the static flat (NB, block) buffer."""
    sizes: Tuple[int, ...]
    block: int
    nbs: Tuple[int, ...]
    starts: Tuple[int, ...]          # block offset of each leaf
    total_blocks: int


def leaf_layout(sizes: Sequence[int], block: int = BLOCK) -> LeafLayout:
    nbs = tuple(n_blocks(n, block) for n in sizes)
    starts, off = [], 0
    for nb in nbs:
        starts.append(off)
        off += nb
    return LeafLayout(sizes=tuple(int(n) for n in sizes), block=block,
                      nbs=nbs, starts=tuple(starts), total_blocks=off)


def config_segments(cfg) -> int:
    """Backward segment count a config asks for: 1 unless
    ``overlap_backward``, else ``backward_segments`` (0 = auto)."""
    if not getattr(cfg, "overlap_backward", False):
        return 1
    return int(getattr(cfg, "backward_segments", 0))


def auto_segments(layout: LeafLayout) -> int:
    """Two segments on any multi-leaf model."""
    return 2 if len(layout.sizes) > 1 else 1


def segment_leaf_bounds(layout: LeafLayout, segments: int
                        ) -> Tuple[int, ...]:
    """Leaf-index bounds splitting the layout into ``segments`` contiguous
    leaf ranges balanced by block count."""
    n = len(layout.sizes)
    segments = max(1, min(int(segments), max(n, 1)))
    if segments <= 1 or n <= 1:
        return (0, n)
    total = max(layout.total_blocks, 1)
    bounds = [0]
    cum = 0
    for i, nb in enumerate(layout.nbs):
        cum += nb
        if (len(bounds) < segments
                and cum * segments >= len(bounds) * total
                and i + 1 < n):
            bounds.append(i + 1)
    bounds.append(n)
    return tuple(bounds)


def seg_grids(level_idx: Sequence[int], layout: LeafLayout,
              levels: Sequence[Level], n_pods: int,
              growth: Optional[float], ring: Optional[int], bidir: bool,
              n_edge: int = 1, hier: Optional[int] = None,
              segments: int = 0):
    """``(bounds, seg_nb, seg_sig, seg_chunks, seg_hier)`` of a
    backward-segmented plan (bounds of length 2: flat plan)."""
    if segments == 0:
        segments = auto_segments(layout)
    bounds = segment_leaf_bounds(layout, segments)
    if len(bounds) <= 2:
        return bounds, (), (), (), ()
    nbs, starts = layout.nbs, layout.starts
    seg_nb, seg_sig, seg_chunks, seg_hier = [], [], [], []
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        base = starts[lo]
        end = starts[hi - 1] + nbs[hi - 1] if hi > lo else base
        seg_nb.append(end - base)
        ssig, sch, shg = exec_grid(
            tuple(level_idx[lo:hi]), layout.sizes[lo:hi], levels, n_pods,
            layout.block, growth, ring, bidir, n_edge=n_edge, hier=hier)
        seg_sig.append(ssig)
        seg_chunks.append(sch)
        seg_hier.append(shg)
    return (bounds, tuple(seg_nb), tuple(seg_sig), tuple(seg_chunks),
            tuple(seg_hier))


@dataclass(frozen=True)
class ExecPlan:
    """A SyncPlan lowered to device tensors + its static grids.

    ``perms`` holds one int32 tensor of gather indices per rung with
    ``sig[r] > 0`` (per segment, for backward-segmented plans, each
    segment's perms local to its own (seg_nb + 1, block) buffer); pad
    entries point at the zero row.  ``omega`` is the f32 aggregation
    weight vector.  Static fields mirror the reference's ExecPlan."""
    levels: Tuple[Level, ...]
    sig: Tuple[int, ...]
    block: int
    total_blocks: int
    perms: tuple
    omega: torch.Tensor
    chunks: Tuple[int, ...] = ()
    bidir: bool = True
    hier: Tuple[int, ...] = ()
    seg_leaves: Tuple[int, ...] = ()
    seg_nb: Tuple[int, ...] = ()
    seg_sig: Tuple[Tuple[int, ...], ...] = ()
    seg_chunks: Tuple[Tuple[int, ...], ...] = ()
    seg_hier: Tuple[Tuple[int, ...], ...] = ()

    @property
    def segmented(self) -> bool:
        return len(self.seg_sig) > 1

    def static_key(self) -> tuple:
        return (self.levels, self.sig, self.chunks, self.bidir,
                self.hier, self.block, self.total_blocks,
                self.seg_leaves, self.seg_nb, self.seg_sig,
                self.seg_chunks, self.seg_hier)


def _rung_perms(level_idx, nbs, starts, sig, base: int, pad: int,
                lo: int, hi: int, L: int, device) -> Tuple[torch.Tensor, ...]:
    """Gather perms for leaves [lo, hi): one int32[sig[r]] per non-empty
    rung, indices relative to ``base``, pad entries at row ``pad``."""
    member = [[] for _ in range(L)]
    for i in range(lo, hi):
        if nbs[i]:
            member[level_idx[i]].append(
                np.arange(starts[i] - base, starts[i] - base + nbs[i],
                          dtype=np.int32))
    perms = []
    for r in range(L):
        S = sig[r]
        if not S:
            continue
        idx = (np.concatenate(member[r]) if member[r]
               else np.zeros((0,), np.int32))
        p = np.full((S,), pad, np.int32)
        p[: idx.shape[0]] = idx
        perms.append(torch.from_numpy(p).to(device))
    return tuple(perms)


def build_exec_plan(plan, sizes: Optional[Sequence[int]] = None, *,
                    block: int = BLOCK, growth: Optional[float] = None,
                    omega=None, n_pods: int = 1, ring: Optional[int] = None,
                    bidir: bool = True, n_edge: int = 1,
                    hier: Optional[int] = None,
                    layout: Optional[LeafLayout] = None,
                    segments: int = 1, device="cuda") -> ExecPlan:
    """Lower a :class:`SyncPlan` to an :class:`ExecPlan` whose perms and
    omega live on ``device``.  ``segments > 1`` builds the
    backward-segmented plan (one pack + exchange per leaf range)."""
    device = resolve_device(device)
    if layout is None:
        if sizes is None:
            raise ValueError("need sizes or a prebuilt layout")
        layout = leaf_layout(sizes, block)
    else:
        block = layout.block
    level_idx = tuple(int(i) for i in plan.level_idx)
    if len(level_idx) != len(layout.sizes):
        raise ValueError(f"plan has {len(level_idx)} groups, layout has "
                         f"{len(layout.sizes)}")
    L = len(plan.levels)
    nbs, starts = layout.nbs, layout.starts
    NB = layout.total_blocks
    sig, chunks, hgrid = exec_grid(level_idx, layout.sizes, plan.levels,
                                   n_pods, block, growth, ring, bidir,
                                   n_edge=n_edge, hier=hier)
    om = plan.omega if omega is None else omega
    kw = dict(levels=tuple(plan.levels), sig=sig, block=block,
              total_blocks=NB, chunks=chunks, bidir=bidir, hier=hgrid,
              omega=torch.as_tensor(om, dtype=torch.float32, device=device))
    bounds, seg_nb, seg_sig, seg_chunks, seg_hier = seg_grids(
        level_idx, layout, plan.levels, n_pods, growth, ring, bidir,
        n_edge=n_edge, hier=hier, segments=segments)
    if len(bounds) > 2:
        seg_perms = []
        for s in range(len(bounds) - 1):
            lo, hi = bounds[s], bounds[s + 1]
            seg_perms.append(_rung_perms(level_idx, nbs, starts, seg_sig[s],
                                         starts[lo], seg_nb[s], lo, hi, L,
                                         device))
        return ExecPlan(perms=tuple(seg_perms), seg_leaves=bounds,
                        seg_nb=seg_nb, seg_sig=seg_sig,
                        seg_chunks=seg_chunks, seg_hier=seg_hier, **kw)
    return ExecPlan(perms=_rung_perms(level_idx, nbs, starts, sig, 0, NB, 0,
                                      len(level_idx), L, device), **kw)


def exec_wire_bytes(ep: ExecPlan, n_pods: int,
                    n_cross: Optional[int] = None) -> int:
    """Analytic per-device cross-tier wire bytes of the exchange ``ep``
    executes (per backward segment for segmented plans)."""
    if ep.segmented:
        return sum(sig_wire_bytes(s, ep.levels, n_pods, ep.block, hier=h,
                                  n_cross=n_cross)
                   for s, h in zip(ep.seg_sig, ep.seg_hier))
    return sig_wire_bytes(ep.sig, ep.levels, n_pods, ep.block,
                          hier=ep.hier, n_cross=n_cross)


def exec_intra_bytes(ep: ExecPlan, n_edge: int) -> int:
    """Intra-tier counterpart of :func:`exec_wire_bytes` (zero on a flat
    fleet)."""
    if ep.segmented:
        return sum(sig_intra_bytes(s, ep.levels, n_edge, ep.block, hier=h)
                   for s, h in zip(ep.seg_sig, ep.seg_hier))
    return sig_intra_bytes(ep.sig, ep.levels, n_edge, ep.block,
                           hier=ep.hier)
