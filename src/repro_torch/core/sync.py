"""ACE-Sync gradient synchronisation (paper eqs. 7-8) — port of
``repro/core/sync.py`` for one pod per process.

    g_ef   = g + gamma * e                         (eq 7, error feedback)
    payload= codec.ef_encode(g_ef)                 (codec from the plan)
    agg    = omega-weighted aggregate              (eq 8)
    e'     = g_ef - decompress(own payload)

Every leaf is laid out block-aligned in one static flat (NB, block)
buffer; per ladder rung a gather permutation of the plan
(:class:`~repro_torch.core.planexec.ExecPlan`) repacks the member leaves,
the rung's codec runs its fused gather + EF + encode round on them (the
Hopper kernels of :mod:`repro_torch.kernels.ops` on the card), and the
aggregate and residual are scattered back through the same permutation.

Rung-ordered apply (``apply_fn``): the optimizer consumes each rung's
aggregate as soon as the rung is done, on the rung's ``(S, block)`` rows
of the packed aux buffers (params / moments, or the anchor).

Backward segments: a segmented plan runs one pack + exchange per leaf
range, walked in reverse leaf order as the reference does.  In this slice
the segments run after the backward pass; interleaving them with it is
later work.  Blockwise codecs make the split exact: segmented and flat
exchanges agree bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Union

import torch

from repro_torch import tree as T
from repro_torch.core import compression as C
from repro_torch.core.planexec import ExecPlan, build_exec_plan, n_blocks
from repro_torch.core.scheduler import SyncPlan


@dataclass(frozen=True)
class GroupMeta:
    name: str
    size: int
    depth: float          # relative depth in the network, [0, 1]
    kind: str             # embed | attn | mlp | other


_KIND_PATTERNS = (
    ("embed", "embed"),
    ("attn", "attn"), ("wq", "attn"), ("wk", "attn"), ("wv", "attn"),
    ("wo", "attn"), ("mix", "attn"),
    ("ffn", "mlp"), ("w_gate", "mlp"), ("w_up", "mlp"), ("w_down", "mlp"),
    ("router", "mlp"),
)


def _kind_of(path: str) -> str:
    for pat, kind in _KIND_PATTERNS:
        if pat in path:
            return kind
    return "other"


def group_metas(param_shapes) -> List[GroupMeta]:
    """Flatten a tree of leaf shapes (tuples, or tensors) into ordered
    per-leaf groups — JAX's sorted-key leaf order."""
    leaves = T.leaves_with_path(param_shapes)
    out = []
    total = max(len(leaves) - 1, 1)
    for i, (path, leaf) in enumerate(leaves):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        out.append(GroupMeta(name=T.path_str(path),
                             size=int(math.prod(shape)), depth=i / total,
                             kind=_kind_of(T.path_str(path))))
    return out


# ---------------------------------------------------------------------------
# static-shape repack + per-rung exchange
# ---------------------------------------------------------------------------


def _leaf_blocks(leaves, block: int, device) -> torch.Tensor:
    """The leaves packed into the static (NB + 1, block) f32 layout, each
    leaf zero-padded to a block multiple and block-aligned, plus the zero
    row NB that pad perm entries gather."""
    nb = sum(n_blocks(l.numel(), block) for l in leaves)
    buf = torch.zeros((nb + 1, block), dtype=torch.float32, device=device)
    flat, off = buf.view(-1), 0
    for l in leaves:
        n = l.numel()
        flat[off:off + n].copy_(l.reshape(-1))
        off += n_blocks(n, block) * block
    return buf


def _unpack(buf: torch.Tensor, like, block: int):
    """Leaves of the shapes/dtypes of ``like`` back out of a packed buffer
    (views where the dtype already matches)."""
    flat, outs, off = buf.view(-1), [], 0
    for leaf in like:
        n = leaf.numel()
        outs.append(flat[off:off + n].view(leaf.shape).to(leaf.dtype))
        off += n_blocks(n, block) * block
    return tuple(outs)


def _range_sync(gs, es, aux, perms, sig, NB, *, levels, block, omega,
                omega_own, scalars, gamma, apply_fn):
    """One leaf range's pack + per-rung exchange + scatter + unpack.
    Returns ``(aggs | aux_outs, errs)`` as leaf tuples for the range."""
    device = gs[0].device
    fb = _leaf_blocks(gs, block, device)
    eb = _leaf_blocks(es, block, device)
    if fb.shape[0] != NB + 1:
        raise ValueError(f"leaf layout has {fb.shape[0] - 1} blocks, plan "
                         f"was built for {NB}")
    abufs = [_leaf_blocks(a, block, device) for a in aux]
    agg = None if apply_fn is not None else torch.zeros_like(fb)
    err = torch.zeros_like(fb)
    pi = 0
    for r, S in enumerate(sig):
        if not S:
            continue
        perm = perms[pi]
        pi += 1
        b_agg, b_err = levels[r].codec.ef_sync_gather(
            fb, eb, perm, omega, omega_own, gamma=gamma, n_pods=1,
            block=block)
        idx = perm.long()
        err.index_copy_(0, idx, b_err.reshape(S, block))
        if apply_fn is None:
            agg.index_copy_(0, idx, b_agg.reshape(S, block))
        else:
            rows = apply_fn(b_agg.reshape(S, block),
                            tuple(ab.index_select(0, idx) for ab in abufs),
                            scalars)
            for ab, nr in zip(abufs, rows):
                ab.index_copy_(0, idx, nr)
    errs = _unpack(err, es, block)
    if apply_fn is None:
        return _unpack(agg, gs, block), errs
    return tuple(_unpack(ab, a, block) for ab, a in zip(abufs, aux)), errs


def sync_tree(tree, errors, plan: Union[SyncPlan, ExecPlan], *,
              gamma: float, block: int = C.BLOCK, n_pods: int = 1,
              apply_fn=None, apply_aux=(), apply_scalars=()):
    """Compress + aggregate a gradient (or delta) tree on one pod.
    Returns ``(agg_tree, new_errors)``, or with ``apply_fn`` given
    ``(tuple_of_new_aux_trees, new_errors)`` (see the module doc).

    ``plan`` may be an :class:`ExecPlan` or a host :class:`SyncPlan`,
    which is lowered here with exact (unpadded) bucket sizes."""
    if n_pods != 1:
        raise NotImplementedError("the multi-pod exchange comes with the "
                                  "multi-pod slice of repro_torch")
    leaves, treedef = T.flatten(tree)
    e_leaves = T.leaves(errors)
    device = leaves[0].device
    if isinstance(plan, SyncPlan):
        ep = build_exec_plan(plan, [l.numel() for l in leaves], block=block,
                             device=device)
    else:
        ep = plan
    omega = ep.omega
    if omega.shape[0] == 1:
        omega = torch.ones((1,), dtype=torch.float32, device=device)
    omega_own = omega[0]
    aux = tuple(tuple(T.leaves(a)) for a in apply_aux)
    kw = dict(levels=ep.levels, block=ep.block, omega=omega,
              omega_own=omega_own, scalars=tuple(apply_scalars),
              gamma=gamma, apply_fn=apply_fn)
    gs, es = tuple(leaves), tuple(e_leaves)
    if not ep.segmented:
        outs, errs = _range_sync(gs, es, aux, ep.perms, ep.sig,
                                 ep.total_blocks, **kw)
    else:
        n_seg = len(ep.seg_sig)
        seg_out: list = [None] * n_seg
        seg_err: list = [None] * n_seg
        # reverse leaf order: backward produces the deep leaves first
        for s in reversed(range(n_seg)):
            lo, hi = ep.seg_leaves[s], ep.seg_leaves[s + 1]
            seg_out[s], seg_err[s] = _range_sync(
                gs[lo:hi], es[lo:hi], tuple(a[lo:hi] for a in aux),
                ep.perms[s], ep.seg_sig[s], ep.seg_nb[s], **kw)
        errs = tuple(e for seg in seg_err for e in seg)
        if apply_fn is None:
            outs = tuple(g for seg in seg_out for g in seg)
        else:
            outs = tuple(tuple(o for seg in seg_out for o in seg[a])
                         for a in range(len(aux)))
    news_tree = T.unflatten(treedef, list(errs))
    if apply_fn is not None:
        return (tuple(T.unflatten(treedef, list(a)) for a in outs),
                news_tree)
    return T.unflatten(treedef, list(outs)), news_tree


def grad_group_stats(tree):
    """Per-group scalars feeding the importance estimator: (mean|g|, var,
    norm), each (G,)."""
    rows, ns = [], []
    for g in T.leaves(tree):
        g32 = g.float().reshape(-1)
        rows.append(torch.stack([g32.abs().sum(), (g32 * g32).sum(),
                                 g32.sum()]))
        ns.append(max(g32.shape[0], 1))
    table = torch.stack(rows)                         # (G, 3)
    n = torch.tensor(ns, dtype=torch.float32, device=table.device)
    mean_abs = table[:, 0] / n
    mean = table[:, 2] / n
    var = torch.clamp_min(table[:, 1] / n - mean * mean, 0.0)
    nrm = torch.sqrt(table[:, 1])
    return mean_abs, var, nrm
