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

  * :meth:`ShardCtx.all_reduce_sum` — in f32, the same bits on every rank
    (NCCL's all-reduce gives that; the gloo branch gathers and sums in
    rank order, as ``PodGroup.all_reduce_sum`` does), rounded once to
    the tensor's dtype;
  * :meth:`ShardCtx.all_gather` along a dimension;
  * :meth:`ShardCtx.all_to_all` — ``jax.lax.all_to_all(tiled=True)``:
    split one dimension into the axis' ranks, concatenate what arrives
    along another, in source-rank order;
  * :meth:`ShardCtx.check_replicated` — a tensor that every rank must
    hold alike, compared across the world; all ranks raise together.

An axis of size 1 makes each of them the identity.  The model code finds
the context through :func:`current_ctx`, installed by
:func:`use_shard_ctx` as the reference's ``use_shard_ctx(mesh)``.

The fit rule (:func:`norm_spec`, :func:`fit_spec`) is the reference's,
over axis sizes instead of a jax mesh: an axis the mesh lacks (or that
is excluded) is dropped, and an axis shards a dimension only if it
divides it — a product where the spec names several — else the
dimension is replicated.  It decides the MoE's token blocks (a decode
step's S = 1 stays whole over "model", as does a batch D does not
divide) and the FSDP split of each weight's d_model dimension over
"data".  Where the port splits by whole units instead (attention heads,
the vocabulary, d_ff: its tensor parallelism), a spec entry
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
    unit replicated over the ``size / units`` ranks that share it (the
    port's choice for K/V heads fewer than the axis); anything else
    raises ``ValueError``."""
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
        """The axis' group, or None where the axis has one rank."""
        if self.sizes[axis] == 1:
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
        """Sum over the axis in f32, the same bits on every rank, rounded
        once to ``x``'s dtype."""
        g = self._group(axis)
        if g is None:
            return x
        x32 = x.float()
        if g.backend == "nccl":
            x32 = x32.clone() if x32 is x else x32
            dist.all_reduce(x32, group=g.pg)
        else:
            x32 = g.all_reduce_sum(x32)
        return x32.to(x.dtype)

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


def reduce_model(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over "model" under
    the installed context (``y`` itself without one)."""
    ctx = current_ctx()
    return y if ctx is None else ctx.all_reduce_sum(y, "model")
