"""ACE-Sync public API — port of ``repro/core/acesync.py``: the state
container and the gradient-sync pass that fuses error feedback (eq 7),
compression (eq 6), aggregation (eq 8) and the online
importance-estimator update (eqs 3-4).

    agg_grads, new_ace, metrics = acesync.sync_gradients(
        grads, ace_state, plan, cfg=run.acesync, pods=group)

With a pod group the per-group gradient stats are averaged across the
pods before they feed the estimator, so the importance state (and the
device replan it drives) is the same on every pod.  On a ("data",
"model") mesh rank the stats are the whole leaves' (``stats_reduce`` and
``sizes``, see ``sync.grad_group_stats``): the same on every rank, while
the sync round runs on the rank's shards.  On a fleet of such meshes
``pods`` is the group of the pods' ranks at this rank's (d, m): the mesh
sum comes first, then the pod mean, as the reference's auto region runs
inside its pod-manual one.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs.base import ACESyncConfig
from repro_torch.core import importance as imp
from repro_torch.core import sync as S
from repro_torch.core.planexec import ExecPlan
from repro_torch.core.scheduler import Scheduler, SyncPlan


class ACEState(NamedTuple):
    errors: dict                 # tree like params (EF residuals)
    importance: imp.ImportanceState
    struct_feat: torch.Tensor    # (G, N_STRUCT) static structural features
    div_ema: torch.Tensor        # divergence EMA scalar
    mse_ema: torch.Tensor        # estimator fit quality


def init_state(generator: torch.Generator, params, metas,
               cfg: ACESyncConfig, device="cuda") -> ACEState:
    device = resolve_device(device)
    struct = imp.structural_features(
        [{"depth": m.depth, "size": m.size, "kind": m.kind} for m in metas],
        device=device)
    errors = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=device), params)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return ACEState(
        errors=errors,
        importance=imp.init_state(generator, len(metas),
                                  cfg.importance_hidden, device),
        struct_feat=struct, div_ema=zero, mse_ema=zero.clone())


def sync_gradients(grads, state: ACEState, plan: Union[SyncPlan, ExecPlan],
                   *, cfg: ACESyncConfig, pods=None, apply_fn=None,
                   apply_aux=(), apply_scalars=(), stats_reduce=None,
                   sizes=None
                   ) -> Tuple[dict, ACEState, Dict[str, torch.Tensor]]:
    """The ACE-Sync round over the pods of ``pods`` (None: one pod).
    Returns (aggregated grads — or, with ``apply_fn``, the tuple of updated
    ``apply_aux`` trees — the new state, metrics)."""
    mean_abs, var, nrm = S.grad_group_stats(grads, stats_reduce, sizes)
    if pods is not None and pods.size > 1:
        # one collective for the three (G,) stat vectors, stacked
        mean_abs, var, nrm = pods.pmean(torch.stack([mean_abs, var, nrm]))
    ist = imp.update_stats(state.importance, mean_abs, var, nrm)
    # online supervision: the observed (normalised) gradient-norm momentum
    # is the ground-truth importance signal for this window
    target = ist.norm_mom / torch.clamp_min(ist.norm_mom.max(), 1e-12)
    ist, mse = imp.train_step(ist, state.struct_feat, target,
                              alpha=cfg.alpha, lr=cfg.importance_lr)
    agg, new_errors = S.sync_tree(grads, state.errors, plan,
                                  gamma=cfg.gamma, block=cfg.topk_block,
                                  pods=pods, fixed_bits=cfg.accum_bits,
                                  apply_fn=apply_fn, apply_aux=apply_aux,
                                  apply_scalars=apply_scalars)
    new_state = state._replace(errors=new_errors, importance=ist,
                               mse_ema=0.99 * state.mse_ema + 0.01 * mse)
    metrics = {"imp_mse": mse, "grad_norm_mean": nrm.mean()}
    return agg, new_state, metrics


def scores_from(importance: imp.ImportanceState, struct_feat,
                cfg: ACESyncConfig) -> torch.Tensor:
    """Scores from the estimator state alone (never the error buffers)."""
    temp = imp.temporal_features(importance)
    return imp.scores(importance.params, temp, struct_feat, cfg.alpha)


def device_replan_fn(scheduler: Scheduler, cfg: ACESyncConfig):
    """The device-resident control plane: ``fn(importance_state,
    struct_feat, budget_bytes) -> int32[G]`` fusing the importance scoring
    (eqs. 3-4) with the tensor knapsack on the scheduler's device, so a
    replan pulls only the tiny assignment vector to the host."""
    cache = getattr(scheduler, "_device_replan_fns", None)
    if cache is None:
        cache = scheduler._device_replan_fns = {}
    fn = cache.get(cfg)
    if fn is None:
        solver = scheduler.device_solver()

        @torch.no_grad()
        def fn(imp_state, struct_feat, budget_bytes):
            temp = imp.temporal_features(imp_state)
            scores = imp.scores(imp_state.params, temp, struct_feat,
                                cfg.alpha)
            budget = torch.as_tensor(budget_bytes, dtype=torch.float32,
                                     device=scores.device)
            return solver(scores, budget)

        cache[cfg] = fn
    return fn
