"""Trainer: model + optimizer + ACE-Sync assembled into step kinds — port
of ``repro/core/trainer.py`` for one pod per process.

Step kinds
----------
  grad_sync   loss/grad -> ACE-Sync compressed aggregation -> AdamW, with
              the rung-ordered apply (``overlap_apply``): AdamW runs on
              each rung's rows as soon as the rung is synced.
  local       loss/grad -> AdamW, no sync (the H-1 local steps).
  delta_sync  compress + aggregate (theta - anchor), theta <- anchor + agg,
              reset the anchor (ACE-Sync's local-update mode).
  param_avg   omega-weighted parameter averaging (FedAvg baseline).

The reference keeps a leading pod dimension on every state leaf so pods
are one SPMD program; here each process holds one pod's state, with no
pod dimension.  The state is a dict of trees of tensors: ``params`` are
the model's own Parameters, updated in place; the other entries are
replaced each step.  PyTorch runs eagerly, so there is no compiled-step
cache: a plan is lowered to an :class:`ExecPlan` (perms on the device)
once per distinct assignment.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch import tree as T
from repro_torch.configs.base import RunConfig
from repro_torch.core import acesync
from repro_torch.core import divergence as D
from repro_torch.core import planexec
from repro_torch.core import sync as S
from repro_torch.core.planexec import ExecPlan, build_exec_plan
from repro_torch.core.scheduler import Scheduler, SyncPlan
from repro_torch.optim import adamw
from repro_torch.strategies import SyncStrategy, resolve_strategy


@torch.no_grad()
def _assign(dst_tree, src_tree) -> None:
    """Copy ``src_tree`` into the tensors of ``dst_tree`` in place."""
    for d, s in zip(T.leaves(dst_tree), T.leaves(src_tree)):
        d.copy_(s)


class Trainer:
    #: max distinct assignments whose ExecPlan stays resident
    _EXEC_CACHE_MAX = 8

    def __init__(self, model, run: RunConfig,
                 strategy: Union[str, SyncStrategy] = "acesync"):
        self.model = model
        self.run = run
        self.device = model.device
        self.strategy = resolve_strategy(strategy)
        self.strategy_name = self.strategy.name
        self.n_pods = 1
        self.param_shapes = model.param_shapes()
        self.metas = S.group_metas(self.param_shapes)
        self.sizes = [m.size for m in self.metas]
        self.scheduler = Scheduler(run.acesync, self.sizes, self.n_pods,
                                   device=self.device)
        self.leaf_layout = planexec.leaf_layout(self.sizes,
                                                run.acesync.topk_block)
        self._exec_cache: Dict = {}

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict:
        """Fresh train state from ``seed`` (the model is initialised in
        place; its RNG stream differs from the reference's)."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.model.init_params(g)
        params = self.model.param_tree()
        opt = adamw.init_opt_state(params)
        ace = acesync.init_state(g, params, self.metas, self.run.acesync,
                                 device=self.device)
        state = {"params": params, "m": opt["m"], "v": opt["v"],
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=self.device),
                 "ace": ace}
        state.update(self.strategy.extra_state(params))
        return state

    # ------------------------------------------------------------------
    # the step bodies
    # ------------------------------------------------------------------
    def _grad_step(self, params, batch):
        leaves, treedef = T.flatten(params)
        with torch.enable_grad():
            loss = self.model.loss(batch)
            grads = torch.autograd.grad(loss, leaves)
        grads = T.unflatten(treedef, list(grads))
        if self.run.grad_clip > 0:
            grads, gnorm = adamw.clip_by_global_norm(grads,
                                                     self.run.grad_clip)
        else:
            gnorm = adamw.global_norm(grads)
        return loss.detach(), grads, gnorm

    def _lr(self, step):
        run = self.run
        return adamw.cosine_schedule(step, base_lr=run.lr,
                                     warmup=run.warmup_steps,
                                     total=run.total_steps)

    def _optimize(self, params, grads, m, v, step):
        run = self.run
        return adamw.adamw_update(
            params, grads, {"m": m, "v": v}, step, lr=self._lr(step),
            beta1=run.beta1, beta2=run.beta2, weight_decay=run.weight_decay)

    def _body_grad_sync(self, st, batch, plan: ExecPlan):
        loss, grads, gnorm = self._grad_step(st["params"], batch)
        run = self.run
        if run.acesync.overlap_apply:
            bc1, bc2 = adamw.bias_corrections(st["step"], run.beta1,
                                              run.beta2)

            def apply_rows(g_rows, aux_rows, scalars):
                p, m, v = aux_rows
                lr_s, bc1_s, bc2_s = scalars
                return adamw.update_rows(
                    p, g_rows, m, v, lr=lr_s, bc1=bc1_s, bc2=bc2_s,
                    beta1=run.beta1, beta2=run.beta2,
                    weight_decay=run.weight_decay)

            out, new_ace, metrics = acesync.sync_gradients(
                grads, st["ace"], plan, cfg=run.acesync,
                apply_fn=apply_rows,
                apply_aux=(st["params"], st["m"], st["v"]),
                apply_scalars=(self._lr(st["step"]), bc1, bc2))
            new_params, new_m, new_v = out
        else:
            agg, new_ace, metrics = acesync.sync_gradients(
                grads, st["ace"], plan, cfg=run.acesync)
            new_params, opt = self._optimize(st["params"], agg, st["m"],
                                             st["v"], st["step"])
            new_m, new_v = opt["m"], opt["v"]
        _assign(st["params"], new_params)
        new_st = dict(st, m=new_m, v=new_v, step=st["step"] + 1,
                      ace=new_ace)
        return new_st, dict(metrics, loss=loss, grad_norm=gnorm)

    def _body_local(self, st, batch, plan: ExecPlan):
        loss, grads, gnorm = self._grad_step(st["params"], batch)
        new_params, opt = self._optimize(st["params"], grads, st["m"],
                                         st["v"], st["step"])
        _assign(st["params"], new_params)
        new_st = dict(st, m=opt["m"], v=opt["v"], step=st["step"] + 1)
        return new_st, {"loss": loss, "grad_norm": gnorm}

    def _body_delta_sync(self, st, batch, plan: ExecPlan):
        """Compress/aggregate (theta - anchor); theta <- anchor + agg, with
        the anchor update rung-ordered under ``overlap_apply``."""
        delta = T.tree_map(lambda p, a: (p - a).to(p.dtype), st["params"],
                           st["anchor"])
        div = D.pod_divergence(st["params"], self.n_pods)
        cfg = self.run.acesync
        if cfg.overlap_apply:
            def apply_anchor(d_rows, aux_rows, _scalars):
                (a_rows,) = aux_rows
                return (a_rows + d_rows,)

            out, new_ace, metrics = acesync.sync_gradients(
                delta, st["ace"], plan, cfg=cfg, apply_fn=apply_anchor,
                apply_aux=(st["anchor"],))
            (new_params,) = out
        else:
            agg, new_ace, metrics = acesync.sync_gradients(
                delta, st["ace"], plan, cfg=cfg)
            new_params = T.tree_map(lambda a, d: (a + d).to(a.dtype),
                                    st["anchor"], agg)
        new_ace = new_ace._replace(
            div_ema=0.9 * st["ace"].div_ema + 0.1 * div)
        _assign(st["params"], new_params)
        # the new anchor: the synced params (new_params is a fresh tree,
        # not the params' own storage)
        new_st = dict(st, anchor=new_params, ace=new_ace)
        return new_st, dict(metrics, divergence=div)

    def _body_param_avg(self, st, batch, plan: ExecPlan):
        """FedAvg baseline: on one pod the weighted average is the pod's
        own parameters."""
        div = D.pod_divergence(st["params"], self.n_pods)
        new_st = dict(st)
        if "anchor" in new_st:
            new_st["anchor"] = T.tree_map(lambda p: p.detach().clone(),
                                          st["params"])
        return new_st, {"divergence": div}

    _BODIES = {"grad_sync": _body_grad_sync, "local": _body_local,
               "delta_sync": _body_delta_sync,
               "param_avg": _body_param_avg}

    # ------------------------------------------------------------------
    # plans and steps
    # ------------------------------------------------------------------
    def exec_plan(self, plan: Union[SyncPlan, ExecPlan]) -> ExecPlan:
        """Lower a host SyncPlan to its device form, cached per distinct
        (assignment, omega) — a cache hit uploads nothing.  Adaptive plans
        use the padded size-class ladder, like the reference."""
        if isinstance(plan, ExecPlan):
            return plan
        key = (plan.levels, plan.level_idx, plan.adaptive,
               tuple(plan.omega))
        ep = self._exec_cache.get(key)
        if ep is None:
            cfg = self.run.acesync
            growth = self.scheduler.pad_growth if plan.adaptive else None
            ep = build_exec_plan(plan, layout=self.leaf_layout,
                                 growth=growth, n_pods=self.n_pods,
                                 bidir=cfg.ring_bidir,
                                 segments=planexec.config_segments(cfg),
                                 device=self.device)
            while len(self._exec_cache) >= self._EXEC_CACHE_MAX:
                self._exec_cache.pop(next(iter(self._exec_cache)))
            self._exec_cache[key] = ep
        return ep

    @torch.no_grad()
    def step(self, state: dict, batch: dict,
             plan: Union[SyncPlan, ExecPlan], kind: str = "grad_sync"):
        """Execute one step kind under ``plan``.  Returns (state,
        metrics); the metrics are device tensors."""
        ep = self.exec_plan(plan)
        return self._BODIES[kind](self, state, batch, ep)

    def default_plan(self, importance=None, bandwidth_mbps: float = 50.0,
                     omega=None) -> SyncPlan:
        """Strategy-owned plan from a synthetic one-device telemetry
        snapshot (the host loop passes real telemetry instead)."""
        return self.strategy.make_plan(
            self.scheduler, importance=importance,
            telemetry=[{"bandwidth_mbps": bandwidth_mbps}], omega=omega)
