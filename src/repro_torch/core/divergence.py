"""Divergence-aware update control (paper eq. 9) — port of
``repro/core/divergence.py`` for one pod per process.

D_k(t) = ||theta_k(t) - theta_bar(t)||_2 measures how far a pod's
parameters have drifted from the fleet mean.  With one pod the pod IS the
fleet mean, so the divergence is identically zero (the reference computes
the same zero from its random projections).  The multi-pod slice ports the
projections and their cross-pod mean.
"""
from __future__ import annotations

import torch


def pod_divergence(params, n_pods: int = 1) -> torch.Tensor:
    """D_k estimate for the calling pod: a scalar tensor on the
    parameters' device."""
    if n_pods != 1:
        raise NotImplementedError("cross-pod divergence comes with the "
                                  "multi-pod slice of repro_torch")
    leaf = params
    while isinstance(leaf, dict):
        leaf = leaf[sorted(leaf)[0]]
    return torch.zeros((), dtype=torch.float32, device=leaf.device)
