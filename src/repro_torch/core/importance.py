"""Attention-based parameter-importance estimator (paper eqs. 3-4) — port
of ``repro/core/importance.py``.

Per parameter group i the estimator produces I(theta_i) in [0, 1]:

    I(theta_i) = alpha * Attn_temp(g_i) + (1 - alpha) * Attn_struct(theta_i)
    Attn_temp(g_i) = sigmoid(W1 * |g_i|_ema + W2 * Var(g_i)_ema)      (eq 4)

The structural branch is a small softmax attention over groups.  The
estimator is trained online with its own Adam; the gradient comes from
``torch.autograd`` where the reference uses ``jax.value_and_grad``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import resolve_device

N_TEMPORAL = 4   # |g| ema, var ema, norm momentum, relative step
N_STRUCT = 6     # rel depth, log size, type one-hot (embed/attn/mlp/other)


class ImportanceState(NamedTuple):
    params: dict             # estimator weights
    opt_m: dict
    opt_v: dict
    feat_ema: torch.Tensor   # (G, 2) ema of mean|g| and var(g)
    norm_mom: torch.Tensor   # (G,) gradient-norm momentum
    step: torch.Tensor       # scalar int32


def init_params(generator: torch.Generator, n_groups: int, hidden: int,
                device="cuda"):
    device = resolve_device(device)
    s = 1.0 / math.sqrt(hidden)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w1": torch.full((1,), 1.0, **f32),
        "w2": torch.full((1,), 1.0, **f32),
        "b_temp": torch.zeros((1,), **f32),
        "wq": normal(N_TEMPORAL, hidden) * 0.3,
        "wk": normal(N_STRUCT, hidden) * 0.3,
        "wv": normal(N_STRUCT, hidden) * 0.3,
        "w_out": normal(hidden, 1) * s,
        "b_out": torch.zeros((1,), **f32),
    }


def init_state(generator: torch.Generator, n_groups: int, hidden: int,
               device="cuda") -> ImportanceState:
    device = resolve_device(device)
    p = init_params(generator, n_groups, hidden, device)
    return ImportanceState(
        params=p, opt_m={k: torch.zeros_like(v) for k, v in p.items()},
        opt_v={k: torch.zeros_like(v) for k, v in p.items()},
        feat_ema=torch.zeros((n_groups, 2), dtype=torch.float32,
                             device=device),
        norm_mom=torch.zeros((n_groups,), dtype=torch.float32,
                             device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def structural_features(group_meta, device="cuda") -> torch.Tensor:
    """group_meta: list of dicts {depth, size, kind}.  Static per model."""
    device = resolve_device(device)
    kinds = {"embed": 0, "attn": 1, "mlp": 2, "other": 3}
    rows = []
    for m in group_meta:
        one = [0.0] * 4
        one[kinds.get(m["kind"], 3)] = 1.0
        rows.append([m["depth"], math.log10(max(m["size"], 1)) / 12.0] + one)
    return torch.tensor(rows, dtype=torch.float32, device=device)


def update_stats(state: ImportanceState, grad_mean_abs, grad_var, grad_norm,
                 decay: float = 0.9) -> ImportanceState:
    """grad_*: (G,) per-group scalars from the current step."""
    feat = torch.stack([grad_mean_abs, grad_var], dim=1)
    feat_ema = decay * state.feat_ema + (1 - decay) * feat
    norm_mom = decay * state.norm_mom + (1 - decay) * grad_norm
    return state._replace(feat_ema=feat_ema, norm_mom=norm_mom,
                          step=state.step + 1)


def temporal_features(state: ImportanceState) -> torch.Tensor:
    g = state.feat_ema
    mu = g.mean(dim=0, keepdim=True)
    sd = g.std(dim=0, keepdim=True, correction=0) + 1e-8
    gn = (g - mu) / sd
    nm = state.norm_mom
    nmn = (nm - nm.mean()) / (nm.std(correction=0) + 1e-8)
    step_feat = (torch.log1p(state.step.float()) / 10.0).expand_as(nmn)
    return torch.stack([gn[:, 0], gn[:, 1], nmn, step_feat], dim=1)


def scores(params, temp_feat, struct_feat, alpha: float) -> torch.Tensor:
    """-> (G,) importance in [0, 1].  eq (3)."""
    attn_temp = torch.sigmoid(params["w1"] * temp_feat[:, 0]
                              + params["w2"] * temp_feat[:, 1]
                              + params["b_temp"])
    q = temp_feat @ params["wq"]          # (G, H)
    k = struct_feat @ params["wk"]        # (G, H)
    v = struct_feat @ params["wv"]        # (G, H)
    att = torch.softmax(q @ k.T / math.sqrt(q.shape[-1]), dim=-1)
    ctx = att @ v
    attn_struct = torch.sigmoid((ctx @ params["w_out"])[:, 0]
                                + params["b_out"])
    return alpha * attn_temp + (1 - alpha) * attn_struct


def train_step(state: ImportanceState, struct_feat, target, *,
               alpha: float, lr: float):
    """One online Adam step toward the observed importance ``target``
    (G,).  Returns (new_state, mse)."""
    temp_feat = temporal_features(state)
    keys = sorted(state.params)
    leaves = [state.params[k].detach().requires_grad_(True) for k in keys]
    with torch.enable_grad():
        s = scores(dict(zip(keys, leaves)), temp_feat, struct_feat, alpha)
        mse = torch.mean((s - target) ** 2)
        grads = torch.autograd.grad(mse, leaves)
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = state.step.float() + 1.0
    new_p, new_m, new_v = {}, {}, {}
    for k, p, g in zip(keys, leaves, grads):
        m = b1 * state.opt_m[k] + (1 - b1) * g
        v = b2 * state.opt_v[k] + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        new_p[k] = p.detach() - lr * mh / (torch.sqrt(vh) + eps)
        new_m[k], new_v[k] = m, v
    return (state._replace(params=new_p, opt_m=new_m, opt_v=new_v),
            mse.detach())
