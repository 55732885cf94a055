"""The within-pod ("data", "model") mesh — port of
``repro/models/shardctx.py``.

The reference annotates activations with logical PartitionSpecs and lets
XLA's SPMD partitioner place them on the ambient mesh.  The port runs one
process per mesh rank over ``torch.distributed`` and says where every
tensor lives itself.  A :class:`ShardCtx` holds this rank's coordinates
(d, m) on a D x M mesh (rank = d * M + m, the device order of the
reference's ``make_mesh((D, M), ("data", "model"))``), its "data" and
"model" sub-groups (``launch/mesh.py``'s ``PodGroup``s) and the world
group, and the collectives the model code needs over one axis:

  * :meth:`ShardCtx.all_reduce_sum` — in f32 (f64 for f64 tensors), the
    same bits on every rank
    (NCCL's all-reduce gives that; the gloo branch gathers and sums in
    rank order, as ``PodGroup.all_reduce_sum`` does), rounded once to
    the tensor's dtype;
  * :meth:`ShardCtx.all_gather` along a dimension;
  * :meth:`ShardCtx.all_to_all` — ``jax.lax.all_to_all(tiled=True)``:
    split one dimension into the axis' ranks, concatenate what arrives
    along another, in source-rank order;
  * :meth:`ShardCtx.all_reduce_max` — the elementwise max over an axis;
  * :meth:`ShardCtx.reduce_scatter` — the sum over the axis of each
    rank's part of a dimension, each rank keeping its own part (the
    ``PodGroup``'s, in rank order under gloo);
  * :meth:`ShardCtx.check_replicated` — a tensor that every rank must
    hold alike, compared across the world; all ranks raise together.

An axis of size 1 makes each of them the identity; the axis "world"
names every rank of the mesh.

Training differentiates through the collectives.  A tensor is either
*replicated* over an axis (every rank holds it alike and computes the
same function of it) or *partial* (each rank holds its own part, or its
own term of a sum).  The adjoints that keep one shared loss counted once
are the ``torch.autograd.Function``s below, installed where the model
code crosses from one to the other:

  * :func:`reduce_model` — partial sums over "model" -> replicated: an
    all-reduce forward, the identity backward (every rank holds the whole
    gradient of the replicated sum already);
  * :func:`copy_to_model` — replicated -> the input of a rank's own
    computation (a column-parallel product, its vocabulary part of the
    LM head): the identity forward, an all-reduce over "model" backward;
  * :func:`gather_data` — FSDP: a weight's "data" shards gathered
    forward, the gradient reduce-scattered backward (the sum over the
    data ranks' batch blocks, each rank keeping its shard's);
  * :func:`split_model` / :func:`gather_model` — the MoE's sequence
    blocks: a replicated sequence cut to this rank's "model" block
    (backward: the blocks' gradients gathered) and the blocks gathered
    back into the replicated residual (backward: this rank's block of the
    replicated gradient);
  * :func:`all_to_all` — expert parallelism: the reverse ``all_to_all``
    backward;
  * :func:`scale_grad` — the identity forward, the gradient scaled
    backward (a computation that every "model" rank repeats alike counts
    1 / M on each);
  * :func:`gather_model_cols` — a "model" shard gathered whole for a
    product that each rank computes only its columns of (the RG-LRU's
    gates, K/V heads fewer than "model"): an all-gather forward, the
    gradient reduce-scattered over "model" backward;
  * :func:`uz_exchange` — a fused [u | z] projection's columns moved
    from the reference's contiguous "model" shard to this rank's own
    channels of both halves (mamba's ``in_proj``): a permutation over
    "model" forward (:meth:`ShardCtx.exchange_halves`), its inverse
    backward.

Parameters replicated over an axis whose gradient each rank computes only
in part (every weight but the FSDP-sharded ones over "data", whose batch
block is the rank's own; the qk-norms and the router over "model") are
summed after the backward by the model
(:meth:`~repro_torch.models.transformer.LanguageModel.reduce_grads`).  The model code finds
the context through :func:`current_ctx`, installed by
:func:`use_shard_ctx` as the reference's ``use_shard_ctx(mesh)``.

The fit rule (:func:`norm_spec`, :func:`fit_spec`) is the reference's,
over axis sizes instead of a jax mesh: an axis the mesh lacks (or that
is excluded) is dropped, and an axis shards a dimension only if it
divides it — a product where the spec names several — else the
dimension is replicated.  It decides the MoE's token blocks (a decode
step's S = 1 stays whole over "model", as does a batch D does not
divide), the FSDP split of each weight's d_model dimension over "data"
and the "model" split of the recurrent mixers' channels and of K/V
columns.  Where the port splits by whole units instead (query heads, the
vocabulary, d_ff, experts: its tensor parallelism), a spec entry
``("model", units)`` says so; see :func:`axis_range`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist

_state = threading.local()


def current_ctx() -> Optional["ShardCtx"]:
    """The installed context, or None (no mesh)."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_shard_ctx(ctx: Optional["ShardCtx"]):
    """Install ``ctx`` (None: no mesh) for :func:`current_ctx`."""
    prev = current_ctx()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


# ---------------------------------------------------------------------------
# the reference's fit rule
# ---------------------------------------------------------------------------


def _norm_axis(ax, names):
    """Drop axis names that the mesh doesn't have."""
    if ax is None:
        return None
    if isinstance(ax, str):
        return ax if ax in names else None
    kept = tuple(a for a in ax if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def norm_spec(spec: Sequence, axis_names, exclude=()) -> tuple:
    """``spec`` with the axes outside ``axis_names`` (or in ``exclude``)
    dropped."""
    names = set(axis_names) - set(exclude)
    return tuple(_norm_axis(ax, names) for ax in spec)


def fit_spec(spec: Sequence, shape, sizes: Mapping[str, int],
             exclude=()) -> tuple:
    """:func:`norm_spec` over the axes of ``sizes`` ({name: size}), then
    per dimension keep the axes whose running product divides it (a
    batch of 1 cannot shard over data = 16: it is replicated)."""
    spec = norm_spec(spec, sizes, exclude)
    out = []
    for d, ax in enumerate(spec):
        if ax is None or d >= len(shape):
            out.append(None if d >= len(shape) else ax)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        kept, prod = [], 1
        for a in axes:
            if shape[d] % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


# ---------------------------------------------------------------------------
# where a rank's shard of a tensor lies
# ---------------------------------------------------------------------------


def axis_range(n: int, size: int, index: int, units: Optional[int] = None):
    """[lo, hi) of a dimension of ``n`` entries held by rank ``index`` of
    an axis of ``size`` ranks.  Without ``units``, the fit rule: equal
    contiguous parts where ``size`` divides ``n``, else the whole
    dimension.  With ``units`` (the dimension holds that many whole
    units, e.g. heads): ``size`` | units splits the units evenly; units
    | ``size`` gives each rank the one unit its place falls in, that
    unit replicated over the ``size / units`` ranks that share it
    (experts fewer than the axis, a layout the trainer refuses: the
    reference splits them); anything else raises ``ValueError``."""
    if size == 1:
        return 0, n
    if units is None:
        if n % size:
            return 0, n
        k = n // size
        return index * k, (index + 1) * k
    if n % units:
        raise ValueError(f"{n} entries are not {units} whole units")
    w = n // units
    if units % size == 0:
        k = units // size
        return index * k * w, (index + 1) * k * w
    if size % units == 0:
        u = index // (size // units)
        return u * w, (u + 1) * w
    raise ValueError(f"{units} units do not split over {size} ranks, nor "
                     f"those ranks over the units")


@dataclasses.dataclass
class ShardCtx:
    """One rank's place on a D x M ("data", "model") mesh: coordinates
    (d, m), rank d * M + m; ``data`` / ``model`` the ``PodGroup``s of the
    ranks that share its m / d (None where there is no process group: a
    context used only for shapes, or an axis of size 1), ``world`` the
    group of all D * M ranks."""

    D: int
    M: int
    d: int = 0
    m: int = 0
    data: object = None
    model: object = None
    world: object = None
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        if not (0 <= self.d < self.D and 0 <= self.m < self.M):
            raise ValueError(f"rank ({self.d}, {self.m}) is not on a "
                             f"({self.D}, {self.M}) mesh")

    @property
    def sizes(self) -> dict:
        return {"data": self.D, "model": self.M}

    @property
    def rank(self) -> int:
        return self.d * self.M + self.m

    def index(self, axis: str) -> int:
        return {"data": self.d, "model": self.m}[axis]

    def _group(self, axis: str):
        """The axis' group ("world": every rank), or None where the axis
        has one rank."""
        n = self.D * self.M if axis == "world" else self.sizes[axis]
        if n == 1:
            return None
        g = getattr(self, axis)
        if g is None:
            raise RuntimeError(f"this context has no {axis!r} group "
                               f"(built for shapes only)")
        return g

    # ---- layout ----------------------------------------------------------
    def local_index(self, spec: Sequence, shape) -> tuple:
        """The slices of a full tensor of ``shape`` this rank holds under
        ``spec``: one entry per dimension, None (whole), "data" / "model"
        (the fit rule) or ``("model", units)`` (:func:`axis_range`)."""
        out = []
        for n, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
            units = None
            if isinstance(ax, tuple):
                ax, units = ax
            if ax is None:
                out.append(slice(None))
                continue
            lo, hi = axis_range(n, self.sizes[ax], self.index(ax), units)
            out.append(slice(lo, hi))
        return tuple(out)

    def local_shape(self, spec: Sequence, shape) -> tuple:
        return tuple(len(range(*s.indices(n))) for s, n in
                     zip(self.local_index(spec, shape), shape))

    def batch_slice(self, B: int) -> slice:
        """The rows of a batch of ``B`` this rank's "data" block holds
        (the fit rule: all of them where D does not divide B)."""
        return slice(*axis_range(B, self.D, self.d))

    # ---- collectives over one axis ----------------------------------------
    def all_reduce_sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the axis in f32 (f64 for f64), the same bits on every
        rank, rounded once to ``x``'s dtype."""
        g = self._group(axis)
        if g is None:
            return x
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if g.backend == "nccl":
            x32 = x32.clone() if x32 is x else x32
            dist.all_reduce(x32, group=g.pg)
        else:
            x32 = g.all_reduce_sum(x32)
        return x32.to(x.dtype)

    def all_reduce_max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max over the axis (exact: the same bits on
        every rank)."""
        g = self._group(axis)
        if g is None:
            return x
        if g.backend == "nccl":
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g.pg)
            return x
        return g.all_gather(x).amax(0)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """Sum ``x`` over the axis, rank q keeping part q of ``dim`` (cut
        into one equal part per rank): the adjoint of :meth:`all_gather`
        along ``dim``."""
        g = self._group(axis)
        if g is None:
            return x
        parts = x.movedim(dim, 0)
        parts = parts.reshape((g.size, parts.shape[0] // g.size)
                              + tuple(parts.shape[1:]))
        return g.reduce_scatter(parts).movedim(0, dim)

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """The axis' ranks' ``x`` concatenated along ``dim`` in rank
        order."""
        g = self._group(axis)
        if g is None:
            return x
        return torch.cat(g.all_gather(x).unbind(0), dim=dim)

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``x`` cut along ``split_dim`` into one part per rank of the
        axis, part q sent to rank q; what arrives is concatenated along
        ``concat_dim`` in source-rank order."""
        g = self._group(axis)
        if g is None:
            return x
        parts = torch.stack(x.chunk(g.size, dim=split_dim))
        return torch.cat(g.all_to_all(parts).unbind(0), dim=concat_dim)

    def exchange_halves(self, x: torch.Tensor, axis: str,
                        inverse: bool = False) -> torch.Tensor:
        """The last dimension of ``x`` from this rank's contiguous part q
        of a fused [u | z] (2 * size * c columns cut into one equal part
        per rank of the axis: part q is blocks 2q and 2q + 1 of c
        columns, block b of u where b < size, else block b - size of z)
        to [u_q | z_q], this rank's block of each half; ``inverse``
        undoes it.  Block b lives on rank b // 2 and belongs to rank
        b % size, so every rank sends two blocks and receives two: one
        ``all_to_all`` of c-column parts, the parts no rank needs zero
        (none at size 2)."""
        g = self._group(axis)
        if g is None:
            return x
        M, q = g.size, self.index(axis)
        c = x.shape[-1] // 2
        halves = x.split(c, dim=-1)
        parts = x.new_zeros((M,) + tuple(x.shape[:-1]) + (c,))
        if inverse:
            # u_q back to the rank holding block q, z_q to block M + q's
            dst, src = (q // 2, (M + q) // 2), ((2 * q) % M,
                                                 (2 * q + 1) % M)
        else:
            dst, src = ((2 * q) % M, (2 * q + 1) % M), (q // 2,
                                                        (M + q) // 2)
        for h, r in zip(halves, dst):
            parts[r] = h
        got = g.all_to_all(parts)
        return torch.cat([got[r] for r in src], dim=-1)

    def gather_batch(self, x: torch.Tensor, B: int) -> torch.Tensor:
        """This rank's block of a batch of ``B`` rows (dim 0) gathered
        over "data" into all of them (``x`` itself where the batch is not
        split)."""
        if self.batch_slice(B) == slice(0, B):
            return x
        return self.all_gather(x, "data", dim=0)

    def check_replicated(self, x: torch.Tensor, what: str) -> None:
        """Raise on every rank unless every rank of the world holds the
        same ``x`` (a rank that diverged would hang the next
        collective)."""
        if self.world is None or self.D * self.M == 1:
            return
        every = self.world.all_gather(x)
        if not bool((every == every[0]).all()):
            bad = [r for r in range(every.shape[0])
                   if not bool((every[r] == every[0]).all())]
            raise RuntimeError(f"{what} differ across the mesh's ranks: "
                               f"ranks {bad} against rank 0")


# ---------------------------------------------------------------------------
# the collectives' adjoints (see the module doc)
# ---------------------------------------------------------------------------


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axis):
        return sctx.all_reduce_sum(x, axis)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axis):
        fctx.sctx, fctx.axis = sctx, axis
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.sctx.all_reduce_sum(g, fctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axis, dim):
        fctx.sctx, fctx.axis, fctx.dim = sctx, axis, dim
        return sctx.all_gather(x, axis, dim)

    @staticmethod
    def backward(fctx, g):
        return (fctx.sctx.reduce_scatter(g.contiguous(), fctx.axis,
                                         fctx.dim), None, None, None)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axis, dim):
        fctx.sctx, fctx.axis, fctx.dim = sctx, axis, dim
        fctx.n = x.shape[dim]
        return sctx.all_gather(x, axis, dim)

    @staticmethod
    def backward(fctx, g):
        i = fctx.sctx.index(fctx.axis)
        return (g.narrow(fctx.dim, i * fctx.n, fctx.n), None, None, None)


class _SplitBlocks(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axis, dim):
        fctx.sctx, fctx.axis, fctx.dim = sctx, axis, dim
        n = x.shape[dim] // sctx.sizes[axis]
        return x.narrow(dim, sctx.index(axis) * n, n)

    @staticmethod
    def backward(fctx, g):
        return (fctx.sctx.all_gather(g.contiguous(), fctx.axis, fctx.dim),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axis, split_dim, concat_dim):
        fctx.args = (sctx, axis, split_dim, concat_dim)
        return sctx.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(fctx, g):
        sctx, axis, split_dim, concat_dim = fctx.args
        return (sctx.all_to_all(g.contiguous(), axis, concat_dim,
                                split_dim), None, None, None, None)


class _Halves(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axis):
        fctx.sctx, fctx.axis = sctx, axis
        return sctx.exchange_halves(x, axis)

    @staticmethod
    def backward(fctx, g):
        return (fctx.sctx.exchange_halves(g.contiguous(), fctx.axis,
                                          inverse=True), None, None)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, scale):
        fctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return g * fctx.scale, None


def _live(ctx, axis: str) -> bool:
    return ctx is not None and ctx._group(axis) is not None


def reduce_model(y: torch.Tensor, ctx: Optional[ShardCtx] = None
                 ) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over "model" under
    ``ctx`` (default: the installed context; ``y`` itself without one):
    the identity backward."""
    ctx = ctx or current_ctx()
    return _Reduce.apply(y, ctx, "model") if _live(ctx, "model") else y


def copy_to_model(x: torch.Tensor, ctx: Optional[ShardCtx] = None
                  ) -> torch.Tensor:
    """A replicated tensor entering this rank's own part of a computation
    over "model": the identity forward, the gradient all-reduced over
    "model" backward."""
    ctx = ctx or current_ctx()
    return _Copy.apply(x, ctx, "model") if _live(ctx, "model") else x


def gather_data(w: torch.Tensor, dim: int,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """An FSDP weight's "data" shards gathered along ``dim``; the
    gradient reduce-scattered over "data" backward."""
    ctx = ctx or current_ctx()
    return _Gather.apply(w, ctx, "data", dim) if _live(ctx, "data") else w


def split_model(x: torch.Tensor, dim: int,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """This rank's "model" block of ``dim`` of a replicated tensor (M
    equal blocks); backward, the blocks' gradients gathered."""
    ctx = ctx or current_ctx()
    if not _live(ctx, "model"):
        return x
    return _SplitBlocks.apply(x, ctx, "model", dim)


def gather_model(x: torch.Tensor, dim: int,
                 ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The "model" ranks' blocks gathered along ``dim`` into a replicated
    tensor; backward, this rank's block of its gradient."""
    ctx = ctx or current_ctx()
    if not _live(ctx, "model"):
        return x
    return _GatherBlocks.apply(x, ctx, "model", dim)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """:meth:`ShardCtx.all_to_all`, its backward the reverse one."""
    ctx = ctx or current_ctx()
    if not _live(ctx, axis):
        return x
    return _AllToAll.apply(x, ctx, axis, split_dim, concat_dim)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x``, its gradient times ``scale``."""
    return x if scale == 1.0 else _ScaleGrad.apply(x, scale)


def gather_model_cols(x: torch.Tensor, dim: int,
                      ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The "model" ranks' parts of ``dim`` gathered whole, for a product
    of which each rank computes its own columns only: backward, the
    gradient summed over "model" and this rank's part kept (a
    reduce-scatter)."""
    ctx = ctx or current_ctx()
    if not _live(ctx, "model"):
        return x
    return _Gather.apply(x, ctx, "model", dim)


def uz_exchange(x: torch.Tensor, ctx: Optional[ShardCtx] = None
                ) -> torch.Tensor:
    """:meth:`ShardCtx.exchange_halves` over "model" on the last
    dimension, its backward the inverse exchange."""
    ctx = ctx or current_ctx()
    if not _live(ctx, "model"):
        return x
    return _Halves.apply(x, ctx, "model")
