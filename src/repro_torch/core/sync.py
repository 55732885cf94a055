"""ACE-Sync gradient synchronisation (paper eqs. 7-8) — port of
``repro/core/sync.py``, one pod per process.

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

Multi-pod (``pods``, a :class:`~repro_torch.launch.mesh.PodGroup`): the
encode pass stops every one-shot payload rung at its packed uint8 wire,
the wires of a leaf range go out in ONE ``all_gather``, and each rung's
slice of the gathered buffer is folded in canonical pod order
(deterministically with 3 or more pods).  Rungs the plan's chunk grid
rings (``ExecPlan.chunks``) stay out of that gather: their bucket is
gathered, encoded by the flat encoder and sent around the chunked ring
in the encode pass (``Codec.ef_sync_ring``), its buffers dropped as soon
as they are encoded.  FULL rungs sum their bf16 contributions across the
pods in the encode pass; SKIP rungs send nothing.

Hierarchical fleet (``pods.n_edge`` > 1: C clusters of E members, slot
``c * E + e``): rungs the plan's tier grid marks two-tier
(``ExecPlan.hier``) materialise their bucket and run
``Codec.ef_sync_hier`` in the encode pass — the intra stage over
``pods.intra`` with the cluster's weights ``omega.reshape(C, E)[c]``,
then one payload per cluster over ``pods.cross``, through the ring where
the chunk grid rings.  Flat rungs join the fleet's coalesced
``all_gather`` and never ring; FULL sums over the whole fleet.

Rung-ordered apply (``apply_fn``): the optimizer consumes each rung's
aggregate as soon as the rung is done, on the rung's ``(S, block)`` rows
of the packed aux buffers (params / moments, or the anchor).

Memory: the residuals are written over the packed errors, and on one pod
each rung runs in row chunks of :data:`SYNC_ROWS` — every codec encodes
a row on its own, so either gives the same bits as the whole bucket.

On a ("data", "model") mesh rank (one pod) the round runs on the rank's
shards: the leaves are the rank's local shards, laid out from their own
sizes, the one-pod round of the reference's nested manual region.

Backward segments: a segmented plan runs one pack + exchange per leaf
range, walked in reverse leaf order as the reference does.  In this slice
the segments run after the backward pass; interleaving them with it is
later work.  Blockwise codecs make the split exact: segmented and flat
exchanges agree bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Union

import torch

from repro_torch import tree as T
from repro_torch.codecs.base import gather_rows
from repro_torch.core import compression as C
from repro_torch.core.planexec import ExecPlan, build_exec_plan, n_blocks
from repro_torch.core.scheduler import SyncPlan
from repro_torch.kernels.ref import FIXED_POINT_BITS

#: rows of a rung that one pod encodes and applies at a time (128 MiB of
#: f32 rows at block 1024)
SYNC_ROWS = 32768


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


def _range_sync(gs, es, aux, perms, sig, chunks, hgrid, NB, *, levels,
                block, omega, omega_own, omega_intra, scalars, gamma,
                apply_fn, pods, bidir, fixed_bits):
    """One leaf range's pack + per-rung exchange + scatter + unpack.
    Returns ``(aggs | aux_outs, errs)`` as leaf tuples for the range."""
    device = gs[0].device
    n_pods = 1 if pods is None else pods.size
    n_edge = 1 if pods is None else pods.n_edge
    fb = _leaf_blocks(gs, block, device)
    eb = _leaf_blocks(es, block, device)
    if fb.shape[0] != NB + 1:
        raise ValueError(f"leaf layout has {fb.shape[0] - 1} blocks, plan "
                         f"was built for {NB}")
    abufs = [_leaf_blocks(a, block, device) for a in aux]
    agg = None if apply_fn is not None else torch.zeros_like(fb)
    # the residuals overwrite the packed errors in place: every row is in
    # exactly one rung's perm (pad entries: the zero row NB, whose residual
    # is zero), and a rung reads its rows of eb before it writes them
    err = eb

    def scatter_agg(S, idx, b_agg):
        if apply_fn is None:
            agg.index_copy_(0, idx, b_agg.reshape(S, block))
            return
        rows = apply_fn(b_agg.reshape(S, block),
                        tuple(ab.index_select(0, idx) for ab in abufs),
                        scalars)
        for ab, nr in zip(abufs, rows):
            ab.index_copy_(0, idx, nr)

    # Encode pass: with more than one pod every one-shot payload rung
    # stops at its packed uint8 wire, and the range's wires go out in ONE
    # all_gather (slicing the gathered concatenation is bit-identical to
    # gathering each piece alone).  Two-tier and ring rungs, FULL / SKIP
    # and the single pod exchange inline.  Residuals and inline aggregates
    # scatter at once, so their buffers die early (the perms are disjoint:
    # the scatter order is free).
    staged, wires, woff = [], [], 0
    pi = 0
    for r, S in enumerate(sig):
        if not S:
            continue
        perm = perms[pi]
        pi += 1
        codec = levels[r].codec
        idx = perm.long()
        k = chunks[r] if chunks else 0
        if hgrid and hgrid[r] and n_edge > 1:
            b_agg, b_err = codec.ef_sync_hier(
                gather_rows(fb, perm).reshape(-1),
                gather_rows(eb, perm).reshape(-1), omega_intra, omega_own,
                gamma=gamma, n_cross=pods.n_cross, n_edge=n_edge,
                intra_mode=hgrid[r], n_chunks=k, block=block,
                cross=pods.cross, intra=pods.intra, bidir=bidir,
                fixed_bits=fixed_bits)
            scatter_agg(S, idx, b_agg)
            del b_agg
        elif n_pods > 1 and codec.supports_ring and k:
            b_agg, b_err = codec.ef_sync_ring(
                gather_rows(fb, perm).reshape(-1),
                gather_rows(eb, perm).reshape(-1), omega, omega_own,
                gamma=gamma, n_pods=n_pods, n_chunks=k, block=block,
                pods=pods, bidir=bidir, fixed_bits=fixed_bits)
            scatter_agg(S, idx, b_agg)
            del b_agg
        elif n_pods > 1 and codec.supports_ring:
            wire, meta, b_err = codec.ef_encode_wire(fb, eb, perm,
                                                     gamma=gamma,
                                                     block=block)
            staged.append((S, idx, codec, meta, woff, wire.numel()))
            wires.append(wire)
            woff += wire.numel()
        else:
            # on one pod nothing crosses a link, every codec encodes a row
            # on its own and the apply is elementwise, so the rung runs in
            # row chunks: the same bits, its temporaries bounded to a
            # chunk's
            step = S if n_pods > 1 else SYNC_ROWS
            for r0 in range(0, S, step):
                n = min(step, S - r0)
                ix = idx[r0:r0 + n]
                b_agg, b_err = codec.ef_sync_gather(
                    fb, eb, perm[r0:r0 + n], omega, omega_own, gamma=gamma,
                    n_pods=n_pods, block=block, pods=pods,
                    fixed_bits=fixed_bits)
                scatter_agg(n, ix, b_agg)
                err.index_copy_(0, ix, b_err.reshape(n, block))
                del b_agg, b_err
            continue
        err.index_copy_(0, idx, b_err.reshape(S, block))
    if wires:
        gathered = pods.all_gather_bytes(
            wires[0] if len(wires) == 1 else torch.cat(wires))
        del wires
        # decode + scatter pass, in rung order
        for S, idx, codec, meta, o, nbytes in staged:
            scatter_agg(S, idx, codec.wire_decode_fold(
                gathered[:, o:o + nbytes], meta, omega, n=S * block,
                block=block, deterministic=n_pods >= 3,
                fixed_bits=fixed_bits))
    errs = _unpack(err, es, block)
    if apply_fn is None:
        return _unpack(agg, gs, block), errs
    return tuple(_unpack(ab, a, block) for ab, a in zip(abufs, aux)), errs


def sync_tree(tree, errors, plan: Union[SyncPlan, ExecPlan], *,
              gamma: float, block: int = C.BLOCK, pods=None,
              ring: Optional[int] = None, bidir: bool = True,
              fixed_bits: int = FIXED_POINT_BITS, apply_fn=None,
              apply_aux=(), apply_scalars=()):
    """Compress + aggregate a gradient (or delta) tree across the pods of
    ``pods`` (None: one pod).  Returns ``(agg_tree, new_errors)``, or with
    ``apply_fn`` given ``(tuple_of_new_aux_trees, new_errors)`` (see the
    module doc).  ``fixed_bits`` is the width of the deterministic
    fixed-point fold used with 3 or more pods (``ACESyncConfig.accum_bits``).

    ``plan`` may be an :class:`ExecPlan` or a host :class:`SyncPlan`,
    which is lowered here with exact (unpadded) bucket sizes; ``ring`` /
    ``bidir`` set its chunk grid (None = the roofline heuristic, <= 0 =
    the one-shot exchange, K = K chunks on every ring-capable rung) and
    ring direction, and a hierarchical ``pods`` its tier grid (the
    roofline's).  ExecPlans carry their own."""
    n_pods = 1 if pods is None else pods.size
    n_edge = 1 if pods is None else pods.n_edge
    leaves, treedef = T.flatten(tree)
    e_leaves = T.leaves(errors)
    device = leaves[0].device
    if isinstance(plan, SyncPlan):
        ep = build_exec_plan(plan, [l.numel() for l in leaves], block=block,
                             n_pods=n_pods, ring=ring, bidir=bidir,
                             n_edge=n_edge, device=device)
    else:
        ep = plan
    omega = ep.omega
    if n_pods == 1 and omega.shape[0] == 1:
        omega = torch.ones((1,), dtype=torch.float32, device=device)
    if omega.shape[0] != n_pods:
        raise ValueError(f"plan omega has {omega.shape[0]} weights for "
                         f"{n_pods} pods")
    # this member's weight, and its cluster's (E,) slice of the fleet's
    # pod-major weights
    omega_own = omega[0 if pods is None else pods.rank]
    omega_intra = (omega.reshape(-1, n_edge)[pods.rank // n_edge]
                   if n_edge > 1 else omega[:1])
    aux = tuple(tuple(T.leaves(a)) for a in apply_aux)
    kw = dict(levels=ep.levels, block=ep.block, omega=omega,
              omega_own=omega_own, omega_intra=omega_intra,
              scalars=tuple(apply_scalars),
              gamma=gamma, apply_fn=apply_fn, pods=pods, bidir=ep.bidir,
              fixed_bits=fixed_bits)
    gs, es = tuple(leaves), tuple(e_leaves)
    if not ep.segmented:
        outs, errs = _range_sync(gs, es, aux, ep.perms, ep.sig, ep.chunks,
                                 ep.hier, ep.total_blocks, **kw)
    else:
        n_seg = len(ep.seg_sig)
        seg_out: list = [None] * n_seg
        seg_err: list = [None] * n_seg
        # reverse leaf order: backward produces the deep leaves first
        for s in reversed(range(n_seg)):
            lo, hi = ep.seg_leaves[s], ep.seg_leaves[s + 1]
            seg_out[s], seg_err[s] = _range_sync(
                gs[lo:hi], es[lo:hi], tuple(a[lo:hi] for a in aux),
                ep.perms[s], ep.seg_sig[s], ep.seg_chunks[s],
                ep.seg_hier[s], ep.seg_nb[s], **kw)
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


def grad_group_stats(tree, reduce=None, sizes=None):
    """Per-group scalars feeding the importance estimator: (mean|g|, var,
    norm), each (G,).  On a mesh rank the leaves are shards: ``reduce``
    maps the (G, 3) per-leaf partial sums of |g|, g^2 and g to the whole
    mesh's (one collective, each element counted once) and ``sizes`` are
    the leaves' global element counts, so the statistics are the whole
    leaves', as the reference computes them."""
    rows, ns = [], []
    for g in T.leaves(tree):
        g32 = g.float().reshape(-1)
        rows.append(torch.stack([g32.abs().sum(), (g32 * g32).sum(),
                                 g32.sum()]))
        ns.append(max(g32.shape[0], 1))
    table = torch.stack(rows)                         # (G, 3)
    if reduce is not None:
        table = reduce(table)
    if sizes is not None:
        ns = [max(int(n), 1) for n in sizes]
    n = torch.tensor(ns, dtype=torch.float32, device=table.device)
    mean_abs = table[:, 0] / n
    mean = table[:, 2] / n
    var = torch.clamp_min(table[:, 1] / n - mean * mean, 0.0)
    nrm = torch.sqrt(table[:, 1])
    return mean_abs, var, nrm
