"""Knapsack bandwidth allocation (paper abstract / conclusion) — port of
``repro/core/knapsack.py``.

Maximise   sum_i I(theta_i) * value(level_i)
subject to sum_i wire_bytes(level_i, n_i) <= budget_bytes

over the static level ladder, with dominated rungs pruned.  Two solvers
share the pruned ladder: :func:`solve`, the host heap/pointer sweep, and
:func:`make_device_solver`, the tensor solver of the device-resident
control plane (one density sort, a cumulative-bytes budget mask and a
per-group cumprod), which returns an ``int32[G]`` assignment on the
device of its inputs.
"""
from __future__ import annotations

import heapq
import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.compression import BLOCK, Level

PodCounts = Union[int, Sequence[int]]


def _per_level_pods(n_pods: PodCounts, n_levels: int) -> List[int]:
    """Broadcast an int accounting pod count to one per level."""
    if isinstance(n_pods, (int, np.integer)):
        return [int(n_pods)] * n_levels
    acct = [int(p) for p in n_pods]
    if len(acct) != n_levels:
        raise ValueError(f"per-level pod counts: expected {n_levels} "
                         f"entries, got {len(acct)}")
    return acct


def level_value(level: Level) -> float:
    """Fraction of gradient 'information' a level preserves (codec's)."""
    return level.codec.value_fraction()


def per_element_cost(level: Level, n_pods: int, block: int = BLOCK) -> float:
    """Size-independent wire cost per element (one block's bytes)."""
    return level.wire_bytes(block, max(n_pods, 2), block) / block


def effective_ladder(levels: Sequence[Level],
                     n_pods: PodCounts) -> List[int]:
    """Rung indices by per-element cost ascending, dominated rungs
    pruned (value must strictly improve on every cheaper rung)."""
    acct = _per_level_pods(n_pods, len(levels))
    order = sorted(range(len(levels)),
                   key=lambda j: per_element_cost(levels[j], acct[j]))
    ladder = []
    for j in order:
        if not ladder or level_value(levels[j]) > \
                level_value(levels[ladder[-1]]) + 1e-12:
            ladder.append(j)
    return ladder


def _item_gain(importance: float, size: int, dv: float) -> float:
    return dv * max(importance, 1e-6) * math.log1p(size)


def solve(importance: Sequence[float], sizes: Sequence[int],
          levels: Sequence[Level], budget_bytes: float,
          n_pods: PodCounts) -> List[int]:
    """-> per-group level index.  Greedy incremental knapsack, one
    heap/pointer sweep (each group's candidate is its next rung)."""
    G = len(importance)
    assert len(sizes) == G
    levels = list(levels)
    acct = _per_level_pods(n_pods, len(levels))
    order = effective_ladder(levels, acct)
    wb = [[levels[j].wire_bytes(sizes[i], acct[j]) for j in order]
          for i in range(G)]
    choice = [order[0]] * G
    spent = sum(wb[i][0] for i in range(G))
    val = [level_value(levels[j]) for j in order]

    heap: List[Tuple[float, int, int, int]] = []

    def push(i: int, pos: int):
        if pos >= len(order):
            return
        db = wb[i][pos] - wb[i][pos - 1]
        if db <= 0:
            return
        dv = _item_gain(importance[i], sizes[i], val[pos] - val[pos - 1])
        heapq.heappush(heap, (-dv / db, i, pos, db))

    for i in range(G):
        push(i, 1)
    while heap:
        _, i, pos, db = heapq.heappop(heap)
        if spent + db > budget_bytes:
            continue
        spent += db
        choice[i] = order[pos]
        push(i, pos + 1)
    return choice


def _group_hull(wb_row: np.ndarray, vals: np.ndarray) -> List[int]:
    """Upper convex hull of one group's (bytes, value) ladder points."""
    hull = [0]
    for p in range(1, len(vals)):
        if wb_row[p] <= wb_row[hull[-1]] or vals[p] <= vals[hull[-1]]:
            continue
        while len(hull) >= 2:
            a, b = hull[-2], hull[-1]
            dens_ab = (vals[b] - vals[a]) / (wb_row[b] - wb_row[a])
            dens_bp = (vals[p] - vals[b]) / (wb_row[p] - wb_row[b])
            if dens_bp >= dens_ab:
                hull.pop()
            else:
                break
        hull.append(p)
    return hull


def make_device_solver(sizes: Sequence[int], levels: Sequence[Level],
                       n_pods: PodCounts, block: int = BLOCK,
                       device="cuda"
                       ) -> Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]:
    """The tensor knapsack for a fixed (sizes, ladder):
    ``fn(importance f32[G], budget_bytes) -> int32[G]`` on ``device``.
    Static tables are numpy-precomputed once (see the reference)."""
    device = resolve_device(device)
    acct = _per_level_pods(n_pods, len(levels))
    order = effective_ladder(list(levels), acct)
    G, Lp = len(sizes), len(order)
    if Lp == 1 or G == 0:
        base_choice = torch.full((G,), order[0] if order else 0,
                                 dtype=torch.int32, device=device)
        return lambda importance, budget_bytes: base_choice

    wb = np.asarray([[levels[j].wire_bytes(int(n), acct[j]) for j in order]
                     for n in sizes], np.float64)          # (G, Lp)
    base = float(wb[:, 0].sum())
    vals = np.asarray([level_value(levels[j]) for j in order])
    hulls = [_group_hull(wb[i], vals) for i in range(G)]
    Hm = max(len(h) for h in hulls)
    item_db = np.zeros((G, Hm - 1), np.float64)
    item_dv = np.zeros((G, Hm - 1), np.float64)
    valid = np.zeros((G, Hm - 1), bool)
    rung_at = np.zeros((G, Hm), np.int32)
    log_sz = np.log1p(np.asarray(sizes, np.float64))
    for i, h in enumerate(hulls):
        rung_at[i] = order[h[-1]]
        for k, p in enumerate(h):
            rung_at[i, k] = order[p]
        for k in range(1, len(h)):
            item_db[i, k - 1] = wb[i, h[k]] - wb[i, h[k - 1]]
            item_dv[i, k - 1] = (vals[h[k]] - vals[h[k - 1]]) * log_sz[i]
            valid[i, k - 1] = True

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    db_t = dev(item_db, torch.float32)
    dv_t = dev(item_dv, torch.float32)
    valid_t = dev(valid, torch.bool)
    rung_t = dev(rung_at, torch.int64)
    base_t = torch.tensor(base, dtype=torch.float32).item()

    def solve_fn(importance: torch.Tensor,
                 budget_bytes: torch.Tensor) -> torch.Tensor:
        imp = torch.clamp_min(importance.float(), 1e-6)[:, None]
        dens = torch.where(valid_t, dv_t * imp / torch.clamp_min(db_t, 1.0),
                           float("-inf"))
        flat_d = dens.reshape(-1)
        flat_b = torch.where(valid_t, db_t, 0.0).reshape(-1)
        by_density = torch.argsort(-flat_d, stable=True)
        cum = torch.cumsum(flat_b[by_density], dim=0)
        afford = ((base_t + cum <= budget_bytes)
                  & torch.isfinite(flat_d[by_density]))
        taken = torch.zeros(flat_d.shape, dtype=torch.bool,
                            device=flat_d.device)
        taken[by_density] = afford
        taken = taken.reshape(G, Hm - 1).to(torch.int64)
        pos = torch.cumprod(taken, dim=1).sum(dim=1)
        return torch.gather(rung_t, 1, pos[:, None])[:, 0].to(torch.int32)

    return solve_fn
