"""First-class synchronization strategies — port of
``repro/strategies/base.py``.

A :class:`SyncStrategy` owns every decision the seed smeared across
``Trainer`` (``_needs_anchor``, ``default_plan``), ``TrainLoop``
(``refresh_plan``, ``adapt_interval``, the step-kind schedule in
``run_steps``) and the CLIs (hard-coded ``choices=[...]`` lists):

  * ``needs_anchor`` / ``extra_state``  — what extra train state the
    strategy requires (e.g. the FedAvg/ACE-Sync anchor copy of params);
  * ``make_plan``                       — telemetry + importance + omega
    -> :class:`~repro_torch.core.scheduler.SyncPlan`;
  * ``step_schedule``                   — which step kinds
    (``grad_sync`` / ``local`` / ``delta_sync`` / ``param_avg``) run at a
    given point of the H-step local window;
  * ``adapt``                           — divergence-driven sync-interval
    control (paper eq. 9), a no-op for fixed-interval strategies;
  * ``wire_bytes``                      — what a given step kind moves over
    the bandwidth-constrained tier (comm accounting for Table 1).

Strategies register themselves by name with :func:`register_strategy`;
``Trainer``, ``TrainLoop``, the launch CLIs, ``scripts/sweep.py`` and the
benchmarks resolve them via :func:`build_strategy` / :func:`list_strategies`,
so adding a new regime is a one-file change::

    from repro_torch.strategies import SyncStrategy, register_strategy

    @register_strategy
    class MyStrategy(SyncStrategy):
        name = "mystrategy"
        def make_plan(self, scheduler, *, importance=None, telemetry=None,
                      omega=None):
            return scheduler.full_plan(omega)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

from repro_torch import tree as T
from repro_torch.configs.base import ACESyncConfig
from repro_torch.core.scheduler import Scheduler, SyncPlan

# The step kinds the trainer knows how to execute (see Trainer._BODIES).
STEP_KINDS = ("grad_sync", "local", "delta_sync", "param_avg")
# Kinds that move bytes across pods and therefore end a local window.
SYNC_KINDS = frozenset({"grad_sync", "delta_sync", "param_avg"})
# Kinds that advance the optimizer step counter (the host loop mirrors the
# device counter with these instead of a blocking device_get per step).
STEP_ADVANCING = frozenset({"grad_sync", "local"})


def mean_bandwidth(telemetry: Optional[Sequence[dict]],
                   default: float = 50.0) -> float:
    """Mean bandwidth (Mbps) over a telemetry snapshot (list of per-device
    dicts with a ``bandwidth_mbps`` key), or ``default`` when absent."""
    if not telemetry:
        return default
    vals = [t["bandwidth_mbps"] for t in telemetry
            if "bandwidth_mbps" in t]
    return sum(vals) / len(vals) if vals else default


class SyncStrategy:
    """Base class: FullSync semantics (dense sync every step, H == 1)."""

    #: registry key; subclasses must override.
    name: str = ""
    #: keep an ``anchor`` copy of params in the train state (delta_sync /
    #: param-averaging strategies reset params against it).
    needs_anchor: bool = False
    #: run the divergence-driven H controller (paper eq. 9) on replan.
    adapts_interval: bool = False
    #: feed importance scores from the online estimator into make_plan.
    uses_importance: bool = False
    #: step kind lowered by the dry-run as "the" fused step of this strategy.
    representative_kind: str = "grad_sync"

    # ---- state ----------------------------------------------------------
    def initial_interval(self, cfg: ACESyncConfig) -> int:
        """Initial H (local steps per cross-pod sync)."""
        return cfg.sync_interval_init if self.adapts_interval else 1

    def extra_state(self, params) -> Dict[str, object]:
        """Extra (param-like) train-state entries the strategy needs."""
        if self.needs_anchor:
            return {"anchor": T.tree_map(lambda p: p.detach().clone(),
                                         params)}
        return {}

    # ---- planning -------------------------------------------------------
    def make_plan(self, scheduler: Scheduler, *,
                  importance: Optional[Sequence[float]] = None,
                  telemetry: Optional[Sequence[dict]] = None,
                  omega: Optional[Sequence[float]] = None,
                  clusters=None) -> SyncPlan:
        """Turn (importance, telemetry, omega) into a compression plan.
        ``clusters`` is the loop's cluster state
        (None outside a TrainLoop; the port has no clusters yet)."""
        return scheduler.full_plan(omega)

    def budget_bandwidth(self, telemetry: Optional[Sequence[dict]] = None,
                         clusters=None, default: float = 50.0) -> float:
        """Bandwidth (Mbps) the byte budget is priced against.  The flat
        strategies budget against the fleet mean; the hierarchical strategy
        overrides this to the bottleneck cluster's mean (the cross-tier
        ring is paced by its weakest pod).  ``clusters`` is the loop's
        cluster state, when one is live."""
        return mean_bandwidth(telemetry, default)

    def device_plan_fn(self, scheduler: Scheduler, cfg: ACESyncConfig):
        """Device-resident replan, if the strategy supports one:
        ``fn(importance_state, struct_feat, budget_bytes) -> int32[G]``
        level assignment that runs entirely on device (the host fetches
        the tiny vector asynchronously and rebuilds the plan off the
        critical path).  ``None`` (the default) means plans only come from
        the host-side :meth:`make_plan`."""
        return None

    def step_schedule(self, steps_since_sync: int, H: int
                      ) -> Tuple[str, ...]:
        """Step kinds to execute at this point of the H-step window.

        The host loop runs the kinds in order and resets its
        ``steps_since_sync`` counter whenever the sequence ends in a kind
        from :data:`SYNC_KINDS`.
        """
        return ("grad_sync",)

    def adapt(self, scheduler: Scheduler, divergence: float) -> int:
        """Divergence-driven sync-interval control; returns the new H."""
        if not self.adapts_interval:
            return self.initial_interval(scheduler.cfg)
        # reference scale: the EMA trend itself (relative control)
        return scheduler.adapt_interval(divergence,
                                        max(divergence, 1e-8) * 10.0)

    # ---- accounting -----------------------------------------------------
    def wire_bytes(self, scheduler: Scheduler, plan: SyncPlan, kind: str,
                   n_pods: Optional[int] = None) -> int:
        """Bytes the given step kind moves over the pod tier per device."""
        if kind == "local":
            return 0
        if kind == "param_avg":
            # plain parameter averaging moves the dense tensors
            return scheduler.plan_wire_bytes(scheduler.full_plan(), n_pods)
        return scheduler.plan_wire_bytes(plan, n_pods)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[SyncStrategy]] = {}


def register_strategy(cls: Type[SyncStrategy]) -> Type[SyncStrategy]:
    """Class decorator: make ``cls`` resolvable by its ``name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if _REGISTRY.get(cls.name) not in (None, cls):
        raise ValueError(f"strategy {cls.name!r} already registered by "
                         f"{_REGISTRY[cls.name].__name__}")
    _REGISTRY[cls.name] = cls
    return cls


def list_strategies() -> List[str]:
    """Registered strategy names (sorted, stable for CLI choices)."""
    return sorted(_REGISTRY)


def get_strategy(name: str) -> Type[SyncStrategy]:
    """Look up a strategy class by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; registered: "
                       f"{list_strategies()}") from None


def build_strategy(name: str, **kwargs) -> SyncStrategy:
    """Instantiate a registered strategy by name."""
    return get_strategy(name)(**kwargs)


def resolve_strategy(spec: Union[str, SyncStrategy, Type[SyncStrategy]]
                     ) -> SyncStrategy:
    """Accept a name, an instance, or a class; return an instance."""
    if isinstance(spec, SyncStrategy):
        return spec
    if isinstance(spec, type) and issubclass(spec, SyncStrategy):
        return spec()
    if isinstance(spec, str):
        return build_strategy(spec)
    raise TypeError(f"cannot resolve strategy from {spec!r}")
