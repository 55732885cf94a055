"""Adaptive compression-expansion scheduling (paper eq. 5) + sync-plan
management — port of ``repro/core/scheduler.py``.

    c_k(t) = c_min + (c_max - c_min) * exp(-beta * B_k(t))        (eq 5)

c is the compression aggressiveness; the byte budget is (1 - c) x the
FullSync volume.  The budget plus the importance scores feed the knapsack
(core/knapsack.py) to produce the per-group level plan, a
:class:`SyncPlan` carrying the same bucket signature the reference
attaches, so both packages price and execute the same plan.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch import resolve_device
from repro_torch.codecs import plan_wire_bytes as _bucketed_plan_bytes
from repro_torch.configs.base import ACESyncConfig
from repro_torch.core import knapsack
from repro_torch.core import planexec
from repro_torch.core.compression import Level


def levels_from_config(cfg: ACESyncConfig) -> List[Level]:
    return [Level(*lv) for lv in cfg.levels]


def compression_level(cfg: ACESyncConfig, bandwidth_mbps: float) -> float:
    """eq (5): c_k(t) = c_min + (c_max-c_min)*exp(-beta*B_k(t))."""
    return cfg.c_min + (cfg.c_max - cfg.c_min) * math.exp(
        -cfg.beta * bandwidth_mbps)


def kept_fraction(cfg: ACESyncConfig, bandwidth_mbps: float) -> float:
    """Fraction of the FullSync byte volume the budget allows."""
    return max(0.02, 1.0 - compression_level(cfg, bandwidth_mbps))


def byte_budget(cfg: ACESyncConfig, bandwidth_mbps: float,
                total_bytes_full: int) -> float:
    return kept_fraction(cfg, bandwidth_mbps) * total_bytes_full


@dataclass
class SyncPlan:
    """Compression plan: one level index per parameter group, plus the
    padded bucket signature the executed exchange moves."""
    level_idx: Tuple[int, ...]
    levels: Tuple[Level, ...]
    omega: Tuple[float, ...]              # per-pod aggregation weights
    sync_interval: int                    # H
    bucket_sig: Optional[Tuple[int, ...]] = None
    bucket_block: Optional[int] = None
    adaptive: bool = False
    ring_chunks: Optional[Tuple[int, ...]] = None
    hier: Optional[Tuple[int, ...]] = None
    seg_sig: Optional[Tuple[Tuple[int, ...], ...]] = None


class Scheduler:
    """Host-side policy engine: telemetry + importance -> SyncPlan."""

    def __init__(self, cfg: ACESyncConfig, group_sizes: Sequence[int],
                 n_pods: int, device="cuda"):
        if n_pods != 1:
            raise NotImplementedError("repro_torch runs one pod per "
                                      "process; the multi-pod slice adds "
                                      "more")
        self.cfg = cfg
        self.sizes = list(group_sizes)
        self.n_pods = n_pods
        self.device = resolve_device(device)
        # price levels as if >= 2 peers exchange (a 1-pod run would see
        # zero cost everywhere and the solver would pick all-SKIP)
        self.acct_pods = max(n_pods, 2)
        self.levels = levels_from_config(cfg)
        self.full_level = next(l for l in self.levels if l.is_full)
        self.sync_interval = cfg.sync_interval_init
        self._full_bytes = sum(
            self.full_level.wire_bytes(n, self.acct_pods)
            for n in self.sizes)
        self.level_acct = [self.acct_pods] * len(self.levels)
        self._layout = planexec.leaf_layout(self.sizes, cfg.topk_block)
        self._device_solver = None

    def _finalize(self, plan: SyncPlan, adaptive: bool) -> SyncPlan:
        """Attach the executed bucket signature (padded classes for
        adaptive plans) and, for segmented lowering, the per-(segment,
        rung) signature."""
        plan.adaptive = adaptive
        growth = self.pad_growth if adaptive else None
        sig, chunks, hier = planexec.exec_grid(
            plan.level_idx, self.sizes, plan.levels, self.n_pods,
            block=self.cfg.topk_block, growth=growth)
        plan.bucket_sig = sig
        plan.ring_chunks = chunks
        plan.hier = hier
        plan.bucket_block = self.cfg.topk_block
        segments = planexec.config_segments(self.cfg)
        if segments != 1:
            _, _, seg_sig, _, _ = planexec.seg_grids(
                plan.level_idx, self._layout, plan.levels, self.n_pods,
                growth, None, self.cfg.ring_bidir, segments=segments)
            plan.seg_sig = seg_sig or None
        return plan

    @property
    def pad_growth(self) -> float:
        return getattr(self.cfg, "bucket_pad_growth", planexec.PAD_GROWTH)

    def full_plan(self, omega: Optional[Sequence[float]] = None) -> SyncPlan:
        fi = self.levels.index(self.full_level)
        return self._finalize(
            SyncPlan(tuple([fi] * len(self.sizes)), tuple(self.levels),
                     self._omega(omega), 1), adaptive=False)

    def uniform_topk_plan(self, ratio: float = 0.1,
                          omega: Optional[Sequence[float]] = None
                          ) -> SyncPlan:
        cand = [i for i, l in enumerate(self.levels)
                if l.is_topk and abs(l.keep_ratio - ratio) < 1e-6]
        idx = cand[0] if cand else min(
            (i for i, l in enumerate(self.levels) if l.is_topk),
            key=lambda i: abs(self.levels[i].keep_ratio - ratio))
        return self._finalize(
            SyncPlan(tuple([idx] * len(self.sizes)), tuple(self.levels),
                     self._omega(omega), 1), adaptive=False)

    def plan(self, importance: Sequence[float], bandwidth_mbps: float,
             omega: Optional[Sequence[float]] = None) -> SyncPlan:
        """ACE-Sync adaptive plan: knapsack under the eq-(5) budget."""
        budget = self.budget_for(bandwidth_mbps)
        choice = knapsack.solve(list(importance), self.sizes, self.levels,
                                budget, self.level_acct)
        return self._finalize(
            SyncPlan(tuple(choice), tuple(self.levels),
                     self._omega(omega), self.sync_interval), adaptive=True)

    def plan_from_levels(self, level_idx: Sequence[int],
                         omega: Optional[Sequence[float]] = None,
                         sync_interval: Optional[int] = None,
                         adaptive: bool = False) -> SyncPlan:
        """A plan from explicit per-group level indices (strategies that
        pick levels themselves, and the fetched device replan)."""
        if len(level_idx) != len(self.sizes):
            raise ValueError(f"expected {len(self.sizes)} level indices, "
                             f"got {len(level_idx)}")
        return self._finalize(
            SyncPlan(tuple(int(i) for i in level_idx), tuple(self.levels),
                     self._omega(omega),
                     self.sync_interval if sync_interval is None
                     else sync_interval), adaptive=adaptive)

    def device_solver(self):
        """The tensor knapsack over this scheduler's (sizes, ladder) on
        its device (cached)."""
        if self._device_solver is None:
            self._device_solver = knapsack.make_device_solver(
                self.sizes, self.levels, self.level_acct,
                block=self.cfg.topk_block, device=self.device)
        return self._device_solver

    def budget_for(self, bandwidth_mbps: float) -> float:
        return byte_budget(self.cfg, bandwidth_mbps, self._full_bytes)

    def adapt_interval(self, divergence: float, div_ref: float) -> int:
        """Paper eq (9): grow H when divergence is small, shrink when it
        exceeds the threshold band."""
        cfg = self.cfg
        rel = divergence / max(div_ref, 1e-12)
        if rel > cfg.div_high:
            self.sync_interval = max(1, self.sync_interval // 2)
        elif rel < cfg.div_low:
            self.sync_interval = min(cfg.sync_interval_max,
                                     self.sync_interval * 2)
        return self.sync_interval

    def _omega(self, omega) -> Tuple[float, ...]:
        if omega is None:
            return tuple([1.0 / self.n_pods] * self.n_pods)
        s = float(sum(omega))
        if not math.isfinite(s) or s <= 0.0:
            raise ValueError(
                f"reliability weights must have a positive finite sum, "
                f"got sum={s!r} over {len(tuple(omega))} weights")
        return tuple(w / s for w in omega)

    def plan_wire_bytes(self, plan: SyncPlan, n_pods: Optional[int] = None,
                        padded: bool = True) -> int:
        """Bytes a sync round under ``plan`` moves per device (bucketed,
        padding included for adaptive plans)."""
        return _bucketed_plan_bytes(
            plan, self.sizes, self.acct_pods if n_pods is None else n_pods,
            self.cfg.topk_block, use_sig=padded)
