"""The built-in synchronization strategies — port of
``repro/strategies/builtin.py`` (``acesync_hier`` belongs to the two-tier
slice and is not ported yet).

The first four are the paper's Table 1 regimes, migrated from the seed's
string dispatch with plan-identical behavior (tests/test_strategies.py
asserts byte-identical ``SyncPlan``s).  ``localsgd`` and
``bandwidth_tiered`` are new regimes the old design could not host without
another round of cross-cutting ``if strategy == ...`` edits.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.scheduler import Scheduler, SyncPlan, kept_fraction
from repro_torch.strategies.base import (SyncStrategy, mean_bandwidth,
                                   register_strategy)


@register_strategy
class FullSync(SyncStrategy):
    """Dense bf16 gradient all-reduce every step (Table 1 baseline)."""
    name = "fullsync"

    def make_plan(self, scheduler: Scheduler, *, importance=None,
                  telemetry=None, omega=None) -> SyncPlan:
        return scheduler.full_plan(omega)


@register_strategy
class TopK(SyncStrategy):
    """Static top-k sparsification, same ratio for every group."""
    name = "topk"

    def __init__(self, ratio: float = 0.1):
        self.ratio = ratio

    def make_plan(self, scheduler: Scheduler, *, importance=None,
                  telemetry=None, omega=None) -> SyncPlan:
        return scheduler.uniform_topk_plan(self.ratio, omega)


class _PeriodicStrategy(SyncStrategy):
    """Shared H-window schedule: H-1 local steps, then one sync step."""
    #: kind executed at the end of each H-step local window.
    sync_kind: str = "param_avg"

    def step_schedule(self, steps_since_sync: int, H: int
                      ) -> Tuple[str, ...]:
        if H <= 1:
            return ("grad_sync",)
        if (steps_since_sync + 1) % H:
            return ("local",)
        return ("local", self.sync_kind)


@register_strategy
class FedAvg(_PeriodicStrategy):
    """Periodic omega-weighted parameter averaging (FedAvg baseline)."""
    name = "fedavg"
    needs_anchor = True
    adapts_interval = True
    sync_kind = "param_avg"

    def make_plan(self, scheduler: Scheduler, *, importance=None,
                  telemetry=None, omega=None) -> SyncPlan:
        return scheduler.full_plan(omega)


@register_strategy
class ACESync(_PeriodicStrategy):
    """The paper's adaptive strategy: importance + eq-(5) bandwidth budget
    -> knapsack plan; compressed delta sync with error feedback; eq-(9)
    divergence-controlled H."""
    name = "acesync"
    needs_anchor = True
    adapts_interval = True
    uses_importance = True
    sync_kind = "delta_sync"

    def make_plan(self, scheduler: Scheduler, *, importance=None,
                  telemetry=None, omega=None) -> SyncPlan:
        imp = (list(importance) if importance is not None
               else [1.0] * len(scheduler.sizes))
        bw = mean_bandwidth(telemetry)
        return scheduler.plan(imp, bw, omega)

    def device_plan_fn(self, scheduler: Scheduler, cfg):
        """Importance scoring + knapsack fused into one device computation
        (core/acesync.device_replan_fn) — the device-resident control
        plane."""
        from repro_torch.core import acesync
        return acesync.device_replan_fn(scheduler, cfg)


@register_strategy
class LocalSGD(SyncStrategy):
    """Periodic parameter averaging with a FIXED sync interval.

    The classic LocalSGD regime ("When Less is More"): H-1 optimizer-only
    local steps, then a plain omega-weighted parameter average — no anchor,
    no error feedback, no divergence controller.  The seed's string
    dispatch could not express this: fixed-H scheduling was hard-wired to
    the fedavg/acesync anchor+adaptation path.
    """
    name = "localsgd"

    def __init__(self, interval: int = 8):
        if interval < 1:
            raise ValueError("localsgd interval must be >= 1")
        self.interval = interval

    def initial_interval(self, cfg) -> int:
        return self.interval

    def adapt(self, scheduler: Scheduler, divergence: float) -> int:
        return self.interval  # fixed by construction

    def make_plan(self, scheduler: Scheduler, *, importance=None,
                  telemetry=None, omega=None) -> SyncPlan:
        fi = scheduler.levels.index(scheduler.full_level)
        return scheduler.plan_from_levels([fi] * len(scheduler.sizes),
                                          omega, sync_interval=self.interval)

    def step_schedule(self, steps_since_sync: int, H: int
                      ) -> Tuple[str, ...]:
        H = max(H, 1)
        if (steps_since_sync + 1) % H:
            return ("local",)
        return ("local", "param_avg")


@register_strategy
class BandwidthTiered(SyncStrategy):
    """Knapsack-free adaptive compression from live telemetry.

    Each replan reads the bandwidth snapshot and picks, per parameter
    group, a codec BY NAME from the scheduler's ladder: when the link is
    fat (kept fraction above ``dense_fraction``) everything goes to the
    ``dense_codec`` (default ``int8``); under a thin link the large groups
    (>= median size) drop to the ``topk`` rung closest to the eq-(5)
    affordable fraction while small groups — cheap in absolute bytes but
    disproportionately important (norms, embeddings' biases) — stay dense.
    A DynaComm-style tiering rule that needs no importance estimator and
    no solver.  Because selection is by registered codec name, widening
    the ladder (int4, sign, ...) is a config change, not a strategy edit:
    ``BandwidthTiered(dense_codec="int4")`` halves the fat-link bytes.
    """
    name = "bandwidth_tiered"

    def __init__(self, dense_fraction: float = 0.45,
                 floor_ratio: float = 0.01, dense_codec: str = "int8"):
        self.dense_fraction = dense_fraction
        self.floor_ratio = floor_ratio
        self.dense_codec = dense_codec

    def _ladder_by_codec(self, scheduler: Scheduler):
        """Map codec name -> level indices of the scheduler's ladder."""
        by_name = {}
        for i, l in enumerate(scheduler.levels):
            by_name.setdefault(l.codec.name, []).append(i)
        return by_name

    def make_plan(self, scheduler: Scheduler, *, importance=None,
                  telemetry=None, omega=None) -> SyncPlan:
        bw = mean_bandwidth(telemetry)
        frac = kept_fraction(scheduler.cfg, bw)
        levels = scheduler.levels
        by_name = self._ladder_by_codec(scheduler)
        dense_cand = by_name.get(self.dense_codec) or by_name.get("int8")
        dense_i = (dense_cand[0] if dense_cand
                   else levels.index(scheduler.full_level))
        topks = [(i, levels[i].keep_ratio) for i in by_name.get("topk", [])]
        sizes = scheduler.sizes
        median = sorted(sizes)[len(sizes) // 2] if sizes else 0
        target = max(frac, self.floor_ratio)
        choice = []
        for n in sizes:
            if frac >= self.dense_fraction or n < median or not topks:
                choice.append(dense_i)
            else:
                choice.append(min(topks,
                                  key=lambda t: abs(t[1] - target))[0])
        # adaptive: replans change with telemetry, so pad bucket classes to
        # keep the compiled step's signature stable across them
        return scheduler.plan_from_levels(choice, omega, sync_interval=1,
                                          adaptive=True)
