"""Plan-as-data: the executable form of a SyncPlan — port of
``repro/core/planexec.py`` for one pod.

Every parameter group is laid out block-aligned in one static flat
(NB, block) buffer (:func:`leaf_layout`).  Per ladder rung, a gather
permutation ``perm_r: int32[S_r]`` of block indices repacks the member
groups into one contiguous per-rung buffer; the tuple of padded per-rung
block counts is the **bucket signature**.  Rung sizes of adaptive plans
are rounded up to the reference's scheduled size classes, so the port's
plans, perms and priced bytes are the reference's, index for index.

The JAX package keeps only the signature static so that replans never
recompile; PyTorch runs eagerly, so here the signature matters only for
pricing and for lining the plans up with the reference.  The ring chunk
grid and the two-tier grid are the multi-pod and two-tier slices' work:
on one pod they are all zeros, as they are in the reference.
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


def exec_grid(level_idx: Sequence[int], sizes: Sequence[int],
              levels: Sequence[Level], n_pods: int, block: int = BLOCK,
              growth: Optional[float] = None, ring: Optional[int] = None,
              bidir: bool = True, n_edge: int = 1,
              hier: Optional[int] = None
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """(sig, chunks, hier) of the executed exchange.  On one pod no rung
    rings and none goes two-tier: both grids are zeros."""
    if n_pods > 1 or n_edge > 1:
        raise NotImplementedError("multi-pod and two-tier grids come with "
                                  "later slices of repro_torch")
    sig = bucket_signature(level_idx, sizes, len(levels), block, growth)
    zeros = tuple(0 for _ in sig)
    return sig, zeros, zeros


def sig_wire_bytes(sig: Sequence[int], levels: Sequence[Level],
                   n_pods: int, block: int = BLOCK) -> int:
    """Per-device wire bytes of an exchange with bucket signature
    ``sig`` (padding included)."""
    return int(sum(levels[r].wire_bytes(S * block, n_pods, block)
                   for r, S in enumerate(sig) if S))


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


def exec_wire_bytes(ep: ExecPlan, n_pods: int) -> int:
    """Analytic per-device wire bytes of the exchange ``ep`` executes."""
    if ep.segmented:
        return sum(sig_wire_bytes(s, ep.levels, n_pods, ep.block)
                   for s in ep.seg_sig)
    return sig_wire_bytes(ep.sig, ep.levels, n_pods, ep.block)
