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

On a rank of a ("data", "model") mesh (``shards``: each leaf's global
shape and this rank's index into it; ``reduce``: the sum over the pod's
mesh of per-leaf partial sums, each shard counted once) the projection
is the pod's global parameters': each rank projects the entries of its
shard that the global leaf's stride samples, with those samples' signs,
and the partial projections are summed over the mesh.  So every rank of
a pod gets the same estimate, and the estimate does not depend on the
mesh's shape (up to the order of f32 sums).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch import tree as T

N_PROJ = 8
MAX_SAMPLE = 65536


def _signs(n: int, seed: int, n_proj: int, device) -> torch.Tensor:
    """(n_proj, n) seeded random signs."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 2, (n_proj, n), generator=g,
                         device=device).float() * 2.0 - 1.0


def _leaf_projections(leaf: torch.Tensor, seed: int,
                      n_proj: int) -> torch.Tensor:
    """(n_proj,) random sign projections of one leaf."""
    flat = leaf.detach().reshape(-1).float()
    n = flat.shape[0]
    if n > MAX_SAMPLE:
        flat = flat[::n // MAX_SAMPLE][:MAX_SAMPLE]
        n = flat.shape[0]
    return _signs(n, seed, n_proj, flat.device) @ flat / math.sqrt(n)


def _shard_projections(shard: torch.Tensor, shape: tuple, index: tuple,
                       seed: int, n_proj: int) -> torch.Tensor:
    """(n_proj,) this shard's part of the projections of its global leaf
    (``shape``; the shard is the leaf's ``index``, a slice per
    dimension): the samples the leaf's stride takes that lie in the
    shard, with their signs."""
    n = math.prod(shape)
    stride = max(n // MAX_SAMPLE, 1)
    n_s = min(MAX_SAMPLE, -(-n // stride))
    dev = shard.device
    pos = torch.arange(n_s, device=dev) * stride   # the samples' entries
    inside = torch.ones(n_s, dtype=torch.bool, device=dev)
    local = torch.zeros(n_s, dtype=torch.int64, device=dev)
    step = 1
    for size, sl in zip(reversed(shape), reversed(index)):
        lo, hi, _ = sl.indices(size)
        coord = pos % size
        pos = pos // size
        inside &= (coord >= lo) & (coord < hi)
        local += (coord - lo) * step
        step *= hi - lo
    take = inside.nonzero().reshape(-1)
    flat = shard.detach().reshape(-1).float()[local[take]]
    return (_signs(n_s, seed, n_proj, dev)[:, take] @ flat
            / math.sqrt(n_s))


def project_params(params, seed: int = 17, n_proj: int = N_PROJ,
                   shards: Optional[Sequence[tuple]] = None,
                   reduce: Optional[Callable] = None) -> torch.Tensor:
    """(n_proj,) projection vector of the whole parameter tree.  On a mesh
    rank ``shards`` gives each leaf's (global shape, index) and
    ``reduce`` sums the (G, n_proj) per-leaf partial projections over the
    pod's mesh (see the module doc)."""
    leaves = T.leaves(params)
    if shards is None:
        parts = [_leaf_projections(leaf, seed + i * 1009, n_proj)
                 for i, leaf in enumerate(leaves)]
    else:
        parts = list(reduce(torch.stack([
            _shard_projections(leaf, shape, index, seed + i * 1009, n_proj)
            for i, (leaf, (shape, index)) in enumerate(zip(leaves,
                                                           shards))])))
    out = None
    for p in parts:
        out = p if out is None else out + p
    return out


def pod_divergence(params, pods=None, seed: int = 17,
                   shards: Optional[Sequence[tuple]] = None,
                   reduce: Optional[Callable] = None) -> torch.Tensor:
    """D_k estimate for the calling pod: a scalar tensor on the
    parameters' device.  ``pods``: the pod group (None: one pod; on a
    fleet of meshes the pods at this rank's (d, m)); ``shards`` /
    ``reduce``: a mesh rank's, as :func:`project_params` takes them."""
    if pods is None or pods.size == 1:
        leaf = T.leaves(params)[0]
        return torch.zeros((), dtype=torch.float32, device=leaf.device)
    proj = project_params(params, seed, shards=shards, reduce=reduce)
    mean = pods.pmean(proj)
    return torch.sqrt(torch.sum((proj - mean) ** 2))
