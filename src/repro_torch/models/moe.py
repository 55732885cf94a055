"""Mixture-of-Experts FFN with capacity dispatch — port of
``repro/models/moe.py``: its single-device path and its mesh branch.

  router logits (f32) -> top-k experts per token -> position in expert by
  a one-hot cumsum over the (token, k) pairs -> scatter into an (E, C, D)
  buffer -> batched expert FFN -> gather back -> gate-weighted combine.

Every expert takes at most C = :func:`capacity` rows; the pairs past it
are dropped, as in the reference: the pairs count in token-major order
(k minor), left-pad tokens take capacity like any other, and among equal
logits the lower expert index wins (``jax.lax.top_k``'s rule, which
``torch.topk`` does not promise, so :func:`route` sorts stably).  The
expert FFN is three batched matmuls over all E experts at their full
capacity, the reference's arithmetic: an expert no token routes to still
runs on zero rows.

Under a ("data", "model") mesh (``models/shardctx.py``) :func:`moe_apply`
follows the reference's ``shard_map`` step for step: the experts are
split over "model" where M divides E (expert parallelism; else every
rank holds them all), each expert's d_model dimension over "data" (FSDP,
gathered by the model before the layer); the tokens are blocked as its
``x_spec`` = fit(("data", "model", None)) blocks them — batch over
"data", sequence over "model", each where the fit rule lets it (a
decode step's S = 1 stays whole over "model").  Each (d, m) block
dispatches on its own with C = capacity(its own token count) and drops
its own pairs, so the answer differs from the unsharded one wherever a
drop does: :func:`moe_apply_blocked` is that semantics on one device,
the oracle of the tests.  An ``all_to_all`` over "model" turns the
(E, C, D) buffer into this rank's experts' (E / M, M * C, D) rows, the
expert FFN runs on them, a second ``all_to_all`` sends the outputs back,
they are combined, and the blocks are gathered back into the residual,
which is replicated over "model".

In training each collective takes its adjoint (``models/shardctx.py``):
the sequence block is cut by ``split_model`` (its gradient gathered over
"model" backward) and gathered back by ``gather_model`` (backward: the
rank's own block of the replicated gradient), the ``all_to_all``s run
in reverse.  Where M does not divide S every "model" rank dispatches the
whole sequence alike: the block enters through ``copy_to_model`` and its
output counts 1 / M of the gradient on each rank (``scale_grad``), so
that the experts, which receive each token from all M ranks, sum to the
gradient once.  The router is replicated over "model" and each rank
computes its gradient in part; the model sums it after the backward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.shardctx import (all_to_all, copy_to_model,
                                        current_ctx, gather_model,
                                        scale_grad, split_model)

#: std of the router's N(0, 1) init (``moe_init``); each expert weight's
#: is 1 / sqrt(shape[-2])
ROUTER_STD = 0.02


def moe_shapes(cfg, n_layers: int):
    D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (n_layers, D, E),
            "w_gate": (n_layers, E, D, Fe),
            "w_up": (n_layers, E, D, Fe),
            "w_down": (n_layers, E, Fe, D)}


def moe_shardings(cfg) -> dict:
    """One layer's specs: the reference's ``moe_shardings`` — experts
    over "model" (where M divides E), d_model over "data"."""
    return {"router": (None, None),
            "w_gate": ("model", "data", None),
            "w_up": ("model", "data", None),
            "w_down": ("model", None, "data")}


def init_std(name: str, shape) -> float:
    """The std of leaf ``name``'s normal init, as ``moe_init``."""
    return ROUTER_STD if name == "router" else shape[-2] ** -0.5


def capacity(n_tokens: int, cfg) -> int:
    """Rows per expert for ``n_tokens`` tokens: ceil(cf * T * K / E)
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(cfg.capacity_factor * n_tokens *
                      cfg.experts_per_token / cfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)


def route(logits: torch.Tensor, k: int):
    """The top ``k`` of each row of ``logits`` (T, E) f32 in
    ``jax.lax.top_k``'s order: descending in the floats' total order
    (-0.0 below +0.0), the lower expert index first among equal logits.
    Returns (gates (T, k): the softmax over the k kept logits, in f32;
    eidx (T, k))."""
    bits = logits.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)   # monotone
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][:, :k]
    return torch.softmax(logits.gather(1, idx), dim=-1), idx


def dispatch(xf: torch.Tensor, logits: torch.Tensor, cfg, C: int):
    """Capacity dispatch of ``xf`` (T, D) by ``logits`` (T, E) f32.
    Returns (ebuf (E, C, D), eidx (T, K), pos_c (T, K): the row of each
    pair in its expert, C where it was dropped, gate_keep (T, K): the
    gates with dropped pairs zeroed, in xf's dtype)."""
    T, D = xf.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    dt = xf.dtype
    gates, eidx = route(logits, K)
    flat_e = eidx.reshape(T * K)
    # the one-hot transposed, (E, T*K), so that the cumsum scans one
    # contiguous row per expert (along dim 0 of the (T*K, E) matrix the
    # prefill ran twice as slow on an H100); built by comparison, as
    # F.one_hot checks its input's range on the host, a sync with the
    # card in every layer
    onehot = (torch.arange(E, device=flat_e.device)[:, None]
              == flat_e[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, 1, dtype=torch.int32).gather(
        0, flat_e[None, :])[0].long() - 1
    keep = pos < C
    pos_c = torch.where(keep, pos, C).reshape(T, K)
    gate_keep = (gates * keep.reshape(T, K)).to(dt)
    # each token's row K times, as the reference's product with ones: the
    # backward sums the K copies' gradients (a reduction, where
    # repeat_interleave's backward accumulates them by index)
    vals = xf[:, None, :].expand(T, K, D).reshape(T * K, D) \
        * keep[:, None].to(dt)
    # row C of each expert takes the dropped pairs (all of them zeros) and
    # is cut off: the kept (expert, row) pairs are unique, so a plain
    # indexed copy places them, without an accumulating scatter
    buf = xf.new_zeros((E, C + 1, D))
    buf[flat_e, pos_c.reshape(-1)] = vals
    return buf[:, :C], eidx, pos_c, gate_keep


def expert_ffn(ebuf, wg, wu, wd):
    """Each expert's SwiGLU over its (C, D) rows: ebuf (E, C, D), wg / wu
    (E, D, Fe), wd (E, Fe, D), in ebuf's dtype."""
    dt = ebuf.dtype
    h = F.silu(ebuf @ wg.to(dt)) * (ebuf @ wu.to(dt))
    return h @ wd.to(dt)


class _PickRows(torch.autograd.Function):
    """``out[eidx, pos_c.clamp(max=C - 1)]``: each (token, k) pair's row
    of the experts' output (E, C, D) -> (T, K, D), a dropped pair reading
    row C - 1.  The backward is the reverse of :func:`dispatch`'s indexed
    copy: the kept (expert, row) pairs are unique, so each kept pair's
    gradient is copied to its row, and the dropped pairs' go to a row C
    that is cut off.  Autograd's own backward of the gather accumulates
    by index instead (atomics on the card) and adds the dropped pairs'
    gradients, 0 * g, into row C - 1; the values are the same."""

    @staticmethod
    def forward(ctx, out, eidx, pos_c):
        ctx.save_for_backward(eidx, pos_c)
        ctx.out_shape = out.shape
        return out[eidx, pos_c.clamp(max=out.shape[1] - 1)]

    @staticmethod
    def backward(ctx, g):
        eidx, pos_c = ctx.saved_tensors
        E, C, D = ctx.out_shape
        grad = g.new_zeros((E, C + 1, D))
        grad[eidx, pos_c] = g
        return grad[:, :C], None, None


def combine(out, eidx, pos_c, gate_keep):
    """Inverse of :func:`dispatch`: each pair's row of ``out`` (E, C, D)
    (a dropped pair reads row C - 1, times its zero gate), gate-weighted
    and summed over k -> (T, D)."""
    picked = _PickRows.apply(out, eidx, pos_c)              # (T, K, D)
    return (picked * gate_keep[..., None]).sum(dim=1)


def _moe_block(p, x, cfg, ctx=None):
    """One dispatch over the tokens of ``x`` (B, S, D): they share the
    capacity C = capacity(B * S).  With ``ctx`` and ``p``'s experts a
    part of the E (expert parallelism), the buffer goes to the experts'
    owners and back over "model"."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    logits = xf.float() @ p["router"].float()
    C = capacity(T, cfg)
    ebuf, eidx, pos_c, gk = dispatch(xf, logits, cfg, C)
    ep = ctx is not None and p["w_gate"].shape[0] < cfg.n_experts
    if ep:      # (E, C, D) -> (E / M, M * C, D): each expert to its owner
        ebuf = all_to_all(ebuf, "model", 0, 1, ctx)
    out = expert_ffn(ebuf, p["w_gate"], p["w_up"], p["w_down"])
    if ep:
        out = all_to_all(out, "model", 1, 0, ctx)
    return combine(out, eidx, pos_c, gk).reshape(B, S, D)


def _seq_blocks(S: int, M: int) -> int:
    """How many "model" blocks the fit rule cuts S positions into."""
    return M if S % M == 0 else 1


def moe_apply(p, x, cfg):
    """x (B, S, D) -> (B, S, D); ``p`` holds one layer's ``router``,
    ``w_gate``, ``w_up``, ``w_down``.  Without a mesh the B * S tokens
    share the capacity of one dispatch.  Under one, ``x`` is this rank's
    "data" block of the residual (replicated over "model"), ``p`` its
    experts with d_model whole: the rank dispatches its "model" block of
    the sequence (or all of it, where M does not divide S), and the
    blocks are gathered back (see the module doc)."""
    ctx = current_ctx()
    if ctx is None:
        return _moe_block(p, x, cfg)
    if _seq_blocks(x.shape[1], ctx.M) == 1:
        y = _moe_block(p, copy_to_model(x, ctx), cfg, ctx)
        return scale_grad(y, 1.0 / ctx.M)
    y = _moe_block(p, split_model(x, 1, ctx), cfg, ctx)
    return gather_model(y, 1, ctx)


def moe_apply_blocked(p, x, cfg, D: int, M: int):
    """The mesh semantics of :func:`moe_apply` on one device, for the
    whole ``x`` (B, S, D) and all of ``p``: each (d, m) token block of a
    (D, M) mesh — batch over D where D divides B, sequence over M where M
    divides S — dispatched on its own, with its own capacity.  The
    oracle of the tests and of the card's gates; the main path does not
    run it."""
    B, S, _ = x.shape
    nb = D if B % D == 0 else 1
    ns = _seq_blocks(S, M)
    bw, sw = B // nb, S // ns
    out = torch.empty_like(x)
    for i in range(nb):
        for j in range(ns):
            rows, cols = slice(i * bw, (i + 1) * bw), slice(j * sw,
                                                            (j + 1) * sw)
            out[rows, cols] = _moe_block(p, x[rows, cols], cfg)
    return out


def load_balance_loss(logits_f32, eidx, cfg):
    """Switch-style auxiliary load-balance loss: E * sum over experts of
    (mean router probability) x (share of tokens whose first choice it
    is).  No loss of the port calls it, as none of the reference's
    does."""
    E = cfg.n_experts
    me = torch.softmax(logits_f32, dim=-1).mean(dim=0)
    ce = F.one_hot(eidx[:, 0], E).float().mean(dim=0)
    return E * torch.sum(me * ce)
