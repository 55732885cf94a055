"""Pluggable synchronization strategies (see base.py for the contract)."""
from repro_torch.strategies.base import (STEP_ADVANCING, STEP_KINDS, SYNC_KINDS,
                                   SyncStrategy, build_strategy,
                                   get_strategy, list_strategies,
                                   mean_bandwidth, register_strategy,
                                   resolve_strategy)
# importing the module runs the @register_strategy decorators
from repro_torch.strategies import builtin  # noqa: F401
from repro_torch.strategies.builtin import (ACESync, BandwidthTiered, FedAvg,
                                      FullSync, LocalSGD, TopK)

__all__ = [
    "STEP_ADVANCING", "STEP_KINDS", "SYNC_KINDS", "SyncStrategy",
    "build_strategy",
    "get_strategy", "list_strategies", "mean_bandwidth",
    "register_strategy", "resolve_strategy",
    "ACESync", "BandwidthTiered", "FedAvg", "FullSync", "LocalSGD", "TopK",
]
