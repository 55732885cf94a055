"""Divergence-aware update control (paper eq. 9) — port of
``repro/core/divergence.py``.

D_k(t) = ||theta_k(t) - theta_bar(t)||_2 estimated with fixed random
projections: each pod projects its parameters onto ``N_PROJ`` shared
random sign directions (leaves above ``MAX_SAMPLE`` entries are
strided-subsampled first, with the same stride on every pod), the pod mean
of the projections is one small collective, and the deviation of a pod's
projections from that mean estimates its divergence (Johnson-
Lindenstrauss).

The sign directions come from a seeded ``torch.Generator``: the same on
every pod of a run, but not the reference's ``jax.random.rademacher``
stream, so the port's estimate agrees with the reference's statistically,
not bit for bit.  With one pod the pod is the fleet mean and the estimate
is exactly zero.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as T

N_PROJ = 8
MAX_SAMPLE = 65536


def _leaf_projections(leaf: torch.Tensor, seed: int,
                      n_proj: int) -> torch.Tensor:
    """(n_proj,) random sign projections of one leaf."""
    flat = leaf.detach().reshape(-1).float()
    n = flat.shape[0]
    if n > MAX_SAMPLE:
        flat = flat[::n // MAX_SAMPLE][:MAX_SAMPLE]
        n = flat.shape[0]
    g = torch.Generator(device=flat.device).manual_seed(seed)
    signs = torch.randint(0, 2, (n_proj, n), generator=g,
                          device=flat.device).float() * 2.0 - 1.0
    return signs @ flat / math.sqrt(n)


def project_params(params, seed: int = 17,
                   n_proj: int = N_PROJ) -> torch.Tensor:
    """(n_proj,) projection vector of the whole parameter tree."""
    out = None
    for i, leaf in enumerate(T.leaves(params)):
        p = _leaf_projections(leaf, seed + i * 1009, n_proj)
        out = p if out is None else out + p
    return out


def pod_divergence(params, pods=None, seed: int = 17) -> torch.Tensor:
    """D_k estimate for the calling pod: a scalar tensor on the
    parameters' device.  ``pods``: the pod group (None: one pod)."""
    if pods is None or pods.size == 1:
        leaf = T.leaves(params)[0]
        return torch.zeros((), dtype=torch.float32, device=leaf.device)
    proj = project_params(params, seed)
    mean = pods.pmean(proj)
    return torch.sqrt(torch.sum((proj - mean) ** 2))
