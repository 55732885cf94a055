"""AdamW + gradient clipping + LR schedule — port of
``repro/optim/adamw.py``.  Same formulas, same association, in f32."""
from __future__ import annotations

import math

import torch

from repro_torch import tree as T


def init_opt_state(params):
    return {"m": T.tree_map(torch.zeros_like, params),
            "v": T.tree_map(torch.zeros_like, params)}


def global_norm(tree, reduce=None) -> torch.Tensor:
    """The 2-norm of every leaf of ``tree`` together.  On a mesh rank the
    leaves are shards: ``reduce`` maps the (G,) per-leaf sums of squares
    to the whole mesh's, each element counted once (the trainer's
    owner-masked sum over the world)."""
    sq = torch.stack([torch.sum(x.float() ** 2) for x in T.leaves(tree)])
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(torch.sum(sq))


def clip_by_global_norm(tree, max_norm: float, reduce=None):
    norm = global_norm(tree, reduce)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return T.tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def bias_corrections(step: torch.Tensor, beta1: float, beta2: float):
    """(bc1, bc2) for the Adam moment bias correction at ``step``."""
    t = step.float() + 1.0
    return 1.0 - beta1 ** t, 1.0 - beta2 ** t


def update_rows(p, g, m, v, *, lr, bc1, bc2, beta1=0.9, beta2=0.95,
                eps=1e-8, weight_decay=0.1):
    """The elementwise AdamW update on same-shape f32 buffers — layout
    free, so the rung-ordered apply runs it on a rung's (S, block) rows.
    Returns (p', m', v') in f32."""
    g32 = g.float()
    p32 = p.float()
    m_new = beta1 * m + (1 - beta1) * g32
    v_new = beta2 * v + (1 - beta2) * g32 * g32
    mh = m_new / bc1
    vh = v_new / bc2
    p_new = p32 - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p32)
    return p_new, m_new, v_new


def adamw_update(params, grads, opt_state, step, *, lr, beta1=0.9,
                 beta2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step over whole trees.  Returns (new_params, new_opt)."""
    bc1, bc2 = bias_corrections(step, beta1, beta2)
    flat_p, tdef = T.flatten(params)
    flat_g = T.leaves(grads)
    flat_m = T.leaves(opt_state["m"])
    flat_v = T.leaves(opt_state["v"])
    out = [update_rows(p, g, m, v, lr=lr, bc1=bc1, bc2=bc2, beta1=beta1,
                       beta2=beta2, eps=eps, weight_decay=weight_decay)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = T.unflatten(tdef, [o[0].to(p.dtype)
                               for o, p in zip(out, flat_p)])
    new_m = T.unflatten(tdef, [o[1] for o in out])
    new_v = T.unflatten(tdef, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v}


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int,
                    total: int, min_frac: float = 0.1):
    s = step.float()
    warm = torch.clamp_max(s / max(warmup, 1), 1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
