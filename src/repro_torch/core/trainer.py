"""Trainer: model + optimizer + ACE-Sync assembled into step kinds — port
of ``repro/core/trainer.py``, one pod per process.

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
pod dimension, and the pods meet in the collectives of their
:class:`~repro_torch.launch.mesh.PodGroup` (``pods``): the sync rounds,
the pod means of the metrics, grad stats and divergence, and
``param_avg``.  The exchange is the config's: the chunked ring on the
rungs the plan's chunk grid rings (``ACESyncConfig.ring_chunks``, 0 =
auto), the one-shot ``all_gather`` elsewhere, and on a hierarchical
fleet (a pod group with ``n_edge`` > 1) the two-tier exchange on the
rungs its tier grid marks (``ACESyncConfig.hier_mode``, 0 = auto).  The
pod group is the whole fleet, its rank the fleet slot, so the pod means
and the ``param_avg`` weights span every member.  The
state is a dict of trees of tensors: ``params`` are the model's own
Parameters, updated in place; the other entries are replaced each step.
PyTorch runs eagerly, so there is no compiled-step cache: a plan is
lowered to an :class:`ExecPlan` (perms on the device) once per distinct
assignment.

On a within-pod ("data", "model") mesh (the model's ``ctx``; one
process per rank) the state is the rank's shards: params, m, v, the
error buffers and the anchor, each leaf as the model shards it.  The
loss, the gradient norm and the importance statistics are global — the
model's loss is the global-batch mean, the gradients are reduced to
each rank's shard of the global gradient (``model.reduce_grads``), and
the per-leaf sums of the norm and the stats are summed over the world
with each element counted once (the first rank holding a shard counts
it).  The ``Scheduler`` prices the plan on the global sizes; the sync
round is the one-pod round on the rank's shards, laid out from the
local sizes (``local_sizes``), the reference's nested manual region.  A
mesh on which a rank's shard is not the reference's local shard is
refused (``ValueError`` naming the leaf).  :meth:`Trainer.state_layout`
places each state leaf of a rank in the checkpoint's global leaf: the
parameter-shaped trees (``PARAM_TREES``) as the parameters, the rest
whole — the reference's ``state_shardings``.

Pods x ("data", "model"): each pod is such a mesh, and ``pods`` is the
group of the P ranks at this rank's (d, m) (``launch.mesh.
split_fleet_mesh``), so the pod of a rank is its rank in ``pods``.  The
pod means (metrics, grad stats, divergence) run over that group after
the mesh sums, as the reference's auto region runs inside its
pod-manual one; the sync round is the pod round on the rank's shards,
its exchange over that group; ``param_avg`` weighs the rank's shards
with its pod's omega.  The divergence projects the pod's global
parameters (``divergence.project_params`` with the shards' places), so
every rank of a pod runs the same H.

A two-tier fleet of meshes (C clusters x E members, each member a D x M
mesh; ``split_fleet_mesh(..., n_edge=E)``): ``pods`` is the group of the
C * E members at this rank's (d, m), its rank the fleet slot c * E + e,
with its ``intra`` and ``cross`` sub-groups.  ``n_pods`` = C * E and
``n_edge`` = E come from it, so the scheduler prices the two-tier plan
of the fleet, and the round runs the two-tier rungs over the sub-groups
on the rank's shards, its tier grid laid out from the local sizes; the
pod means and ``param_avg``'s weight span the C * E members, as above.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import LeafShard, whole_leaves
from repro_torch.configs.base import RunConfig
from repro_torch.core import acesync
from repro_torch.core import divergence as D
from repro_torch.core import planexec
from repro_torch.core import sync as S
from repro_torch.core.planexec import ExecPlan, build_exec_plan
from repro_torch.core.scheduler import Scheduler, SyncPlan
from repro_torch.kernels.ref import ftz
from repro_torch.optim import adamw
from repro_torch.strategies import SyncStrategy, resolve_strategy


@torch.no_grad()
def _assign(dst_tree, src_tree) -> None:
    """Copy ``src_tree`` into the tensors of ``dst_tree`` in place."""
    for d, s in zip(T.leaves(dst_tree), T.leaves(src_tree)):
        d.copy_(s)


#: the train state's parameter-shaped trees: on a mesh each of their leaves
#: is sharded as its parameter (the reference's ``state_shardings``), every
#: other leaf is whole on every rank
PARAM_TREES = ("params/", "m/", "v/", "ace/errors/", "anchor/")


def param_path(key: str) -> Optional[str]:
    """The parameter a state leaf of a parameter-shaped tree follows
    (``m/blocks/slot0/attn/wq`` -> ``blocks/slot0/attn/wq``), else None."""
    tree = next((t for t in PARAM_TREES if key.startswith(t)), None)
    return None if tree is None else key[len(tree):]


#: the model families whose training is ported: every family of the zoo —
#: the dense transformers (the VLM among them), the capacity-dispatch MoE,
#: mamba (``ssm``), the RG-LRU hybrid (``hybrid``) and the
#: encoder-decoder (``encdec``)
TRAINED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


class Trainer:
    #: max distinct assignments whose ExecPlan stays resident
    _EXEC_CACHE_MAX = 8

    def __init__(self, model, run: RunConfig,
                 strategy: Union[str, SyncStrategy] = "acesync", pods=None):
        if model.cfg.family not in TRAINED_FAMILIES:
            raise NotImplementedError(
                f"{model.cfg.name}: training the {model.cfg.family!r} "
                f"family is not ported yet")
        #: the model's ("data", "model") mesh (None: one card)
        self.ctx = getattr(model, "ctx", None)
        if self.ctx is not None:
            model.check_reference_shards()
        self.model = model
        self.run = run
        self.device = model.device
        self.strategy = resolve_strategy(strategy)
        self.strategy_name = self.strategy.name
        self.pods = pods
        self.n_pods = 1 if pods is None else pods.size
        self.n_edge = 1 if pods is None else pods.n_edge
        self.param_shapes = model.global_param_shapes()
        self.metas = S.group_metas(self.param_shapes)
        #: the leaves' global sizes (what the scheduler prices) and this
        #: rank's shards' (what the sync round lays out)
        self.sizes = [m.size for m in self.metas]
        self.local_sizes = [p.numel() for p in T.leaves(model.param_tree())]
        self.scheduler = Scheduler(run.acesync, self.sizes, self.n_pods,
                                   n_edge=self.n_edge, device=self.device)
        self.leaf_layout = planexec.leaf_layout(self.local_sizes,
                                                run.acesync.topk_block)
        self._exec_cache: Dict = {}
        self._owned = None
        #: each leaf's (global shape, this rank's index) on a mesh, for the
        #: divergence's projections
        self._shards = None
        if self.ctx is not None:
            self._owned = torch.tensor(model.owned_leaves(),
                                       dtype=torch.float32,
                                       device=self.device)
            self._shards = [model.shard_of(T.path_str(q))[:2] for q, _ in
                            T.leaves_with_path(model.param_tree())]

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict:
        """Fresh train state from ``seed`` (the model is initialised in
        place; its RNG stream differs from the reference's)."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.model.init_params(g)
        return self.state_of_params(g)

    def state_of_params(self, generator: torch.Generator) -> dict:
        """The train state around the model's Parameters as they stand:
        zero moments and error buffers, the strategy's extra state, the
        importance estimator drawn from ``generator`` (on any device: a
        dry run's model lives on the meta device, where no generator
        does)."""
        g = generator
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

    def state_layout(self, state) -> List[LeafShard]:
        """Where each leaf of ``state`` (this rank's, in the reference's
        order) lies in the checkpoint's global leaf: on a mesh a leaf of a
        parameter-shaped tree is its parameter's shard, written by the
        first rank holding that shard (``model.shard_of``), and every
        other leaf is whole, written by rank 0; without a mesh every leaf
        is whole and written by this process."""
        if self.ctx is None:
            return whole_leaves(state)
        out = []
        for path, leaf in T.reference_leaves_with_path(state):
            p = param_path(T.path_str(path))
            if p is None:
                out.append(LeafShard(tuple(leaf.shape),
                                     tuple(slice(None) for _ in leaf.shape),
                                     self.ctx.rank == 0))
            else:
                out.append(LeafShard(*self.model.shard_of(p)))
        return out

    # ------------------------------------------------------------------
    # the step bodies
    # ------------------------------------------------------------------
    def _pmean(self, x: torch.Tensor) -> torch.Tensor:
        if self.n_pods == 1:
            return x
        return self.pods.pmean(x.float().reshape(1)).reshape(())

    def _pod_metrics(self, loss, gnorm) -> Dict[str, torch.Tensor]:
        """Loss and grad norm averaged over the pods (one collective)."""
        if self.n_pods == 1:
            return {"loss": loss, "grad_norm": gnorm}
        both = self.pods.pmean(torch.stack([loss.float(), gnorm.float()]))
        return {"loss": both[0], "grad_norm": both[1]}

    def _mesh_sum(self, per_leaf: torch.Tensor) -> torch.Tensor:
        """Per-leaf partial sums (G, ...) of this rank's shards -> the whole
        mesh's, each shard counted by the first rank that holds it."""
        owned = self._owned.reshape((-1,) + (1,) * (per_leaf.dim() - 1))
        return self.ctx.all_reduce_sum(per_leaf * owned, "world")

    def _grad_step(self, params, batch):
        leaves, treedef = T.flatten(params)
        with torch.enable_grad():
            loss = self.model.loss(batch)
            grads = torch.autograd.grad(loss, leaves)
        reduce = None
        if self.ctx is not None:
            grads = self.model.reduce_grads(grads)
            reduce = self._mesh_sum
        grads = T.unflatten(treedef, list(grads))
        if self.run.grad_clip > 0:
            grads, gnorm = adamw.clip_by_global_norm(
                grads, self.run.grad_clip, reduce)
        else:
            gnorm = adamw.global_norm(grads, reduce)
        return loss.detach(), grads, gnorm

    def _divergence(self, params) -> torch.Tensor:
        """The pod-mean divergence estimate (eq. 9's D_k), the same on
        every rank of a pod."""
        reduce = None if self.ctx is None else self._mesh_sum
        return self._pmean(D.pod_divergence(params, self.pods,
                                            shards=self._shards,
                                            reduce=reduce))

    def _sync_kw(self) -> dict:
        """The sync round's keywords: the pod group, and on a mesh the
        global statistics' reduction and sizes."""
        kw = dict(cfg=self.run.acesync, pods=self.pods)
        if self.ctx is not None:
            kw.update(stats_reduce=self._mesh_sum, sizes=self.sizes)
        return kw

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
                grads, st["ace"], plan, **self._sync_kw(),
                apply_fn=apply_rows,
                apply_aux=(st["params"], st["m"], st["v"]),
                apply_scalars=(self._lr(st["step"]), bc1, bc2))
            new_params, new_m, new_v = out
        else:
            agg, new_ace, metrics = acesync.sync_gradients(
                grads, st["ace"], plan, **self._sync_kw())
            new_params, opt = self._optimize(st["params"], agg, st["m"],
                                             st["v"], st["step"])
            new_m, new_v = opt["m"], opt["v"]
        _assign(st["params"], new_params)
        new_st = dict(st, m=new_m, v=new_v, step=st["step"] + 1,
                      ace=new_ace)
        return new_st, dict(metrics, **self._pod_metrics(loss, gnorm))

    def _body_local(self, st, batch, plan: ExecPlan):
        loss, grads, gnorm = self._grad_step(st["params"], batch)
        new_params, opt = self._optimize(st["params"], grads, st["m"],
                                         st["v"], st["step"])
        _assign(st["params"], new_params)
        new_st = dict(st, m=opt["m"], v=opt["v"], step=st["step"] + 1)
        return new_st, self._pod_metrics(loss, gnorm)

    def _body_delta_sync(self, st, batch, plan: ExecPlan):
        """Compress/aggregate (theta - anchor); theta <- anchor + agg, with
        the anchor update rung-ordered under ``overlap_apply``."""
        delta = T.tree_map(lambda p, a: (p - a).to(p.dtype), st["params"],
                           st["anchor"])
        div = self._divergence(st["params"])
        cfg = self.run.acesync
        if cfg.overlap_apply:
            def apply_anchor(d_rows, aux_rows, _scalars):
                (a_rows,) = aux_rows
                return (a_rows + d_rows,)

            out, new_ace, metrics = acesync.sync_gradients(
                delta, st["ace"], plan, **self._sync_kw(),
                apply_fn=apply_anchor, apply_aux=(st["anchor"],))
            (new_params,) = out
        else:
            agg, new_ace, metrics = acesync.sync_gradients(
                delta, st["ace"], plan, **self._sync_kw())
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
        """FedAvg baseline: the omega-weighted parameter average across
        the pods (on one pod, the pod's own parameters); the weight is
        the fleet slot's (on a fleet of meshes the rank's pod's, its
        shards averaged with the other pods' same shards)."""
        div = self._divergence(st["params"])
        if self.n_pods > 1:
            w = plan.omega[self.pods.rank]
            avg = T.tree_map(
                lambda p: self.pods.all_reduce_sum(ftz(p.float() * w))
                .to(p.dtype), st["params"])
            _assign(st["params"], avg)
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
                                 ring=planexec.ring_override(
                                     cfg.ring_chunks),
                                 bidir=cfg.ring_bidir, n_edge=self.n_edge,
                                 hier=planexec.hier_override(cfg.hier_mode),
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
        snapshot (the host loop passes real telemetry instead); omega
        defaults to uniform over the pods."""
        return self.strategy.make_plan(
            self.scheduler, importance=importance,
            telemetry=[{"bandwidth_mbps": bandwidth_mbps}], omega=omega)
