"""Mamba-1 selective-state-space LM (falcon-mamba-7b) — port of
``repro/models/mamba.py``.

The selective scan runs the recurrence
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
chunk by chunk (the reference's chunk rule, :func:`scan_chunk`): within a
chunk of Q positions the (B, Q, D_inner, N) discretised tensors are built
and scanned in log2(Q) batched levels (:func:`chunked_linear_recurrence`,
pairwise reduction as ``jax.lax.associative_scan`` does it), and only the
(B, D_inner, N) state is carried from one chunk to the next, so the
(B, S, D_inner, N) tensor of the whole sequence never exists.  The scan
is f32 whatever the compute dtype; the projections, the depthwise conv
and the gates run in the compute dtype, as in the reference.

:class:`RecurrentLM` holds what this model and the hybrid
(``models/rglru.py``) share: the embedding and final norm, on the model
API of ``transformer.LanguageModel`` (``forward``, ``loss``, ``logits``,
``prefill``, ``decode_step``).  Caches (the conv carry and the scan
state, per layer) are written in place, as the dense ring caches are.

Under a ("data", "model") mesh (``ctx``) each Parameter holds this
rank's shard of the reference's ``_ssm_layer_shardings``
(:func:`ssm_layer_shardings`): d_inner split over "model" — the conv,
``dt_proj``'s columns, ``A_log``, ``D``, ``dt_bias``, the rows of
``x_proj`` and ``out_proj`` — and ``in_proj`` / ``out_proj`` FSDP over
"data".  ``in_proj``'s shard is the reference's contiguous part of the
fused (D, 2 * d_inner) [u | z] columns (at model = 2, rank 0 holds all
of u): :func:`mamba_mix` moves the columns to this rank's channels of
both halves over "model" (``shardctx.uz_exchange`` on the projection's
output), so the parameter, the
sync round and the checkpoints keep the reference's shard.  ``x_proj``
is row-parallel (its (B, S, R + 2N) output summed over "model"),
``dt_proj`` column-parallel from that sum, the conv and the scan run on
the rank's channels alone, and ``out_proj``'s partial sums are summed
over "model".  The caches hold the rank's batch block and channels.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.shardctx import (ShardCtx, copy_to_model,
                                        current_ctx, reduce_model,
                                        use_shard_ctx, uz_exchange)
from repro_torch.models.transformer import _DTYPES, LanguageModel, unstack

SCAN_CHUNK = 256
#: the profiler ranges of :class:`SelectiveScan`'s forward and backward
SCAN_RANGES = ("selective_scan.forward", "selective_scan.backward")


def ssm_layer_shapes(cfg) -> dict:
    """One mamba layer's parameter shapes (without the layer axis)."""
    D, Di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_dt_rank, cfg.ssm_conv)
    return {"in_proj": (D, 2 * Di), "conv_w": (W, Di), "conv_b": (Di,),
            "x_proj": (Di, R + 2 * N), "dt_proj": (R, Di), "dt_bias": (Di,),
            "A_log": (Di, N), "D": (Di,), "out_proj": (Di, D), "norm": (D,)}


def ssm_layer_shardings() -> dict:
    """One mamba layer's specs: the reference's ``_ssm_layer_shardings``
    (d_inner over "model", ``in_proj`` / ``out_proj`` FSDP over "data"
    on d_model)."""
    return {"in_proj": ("data", "model"), "conv_w": (None, "model"),
            "conv_b": ("model",), "x_proj": ("model", None),
            "dt_proj": (None, "model"), "dt_bias": ("model",),
            "A_log": ("model", None), "D": ("model",),
            "out_proj": ("model", "data"), "norm": (None,)}


# ---------------------------------------------------------------------------
# activations as the reference composes them
# ---------------------------------------------------------------------------
# jax.nn's sigmoid, silu, softplus and (tanh) gelu are compositions of
# elementwise ops, each rounded to the input's dtype as XLA runs them;
# torch's fused versions round once, which in bf16 differs in 15-45% of
# the outputs.  These apply the same ops in the same order (each torch op
# on a bf16 tensor rounds its result), with constants rounded to the
# dtype as jax rounds them.  Where the reference casts such a result to
# f32, XLA (allowing excess precision) drops the bf16 round trip and
# reads the final op's f32 result: ``f32=True`` returns that.


def _last(x, f32: bool):
    return x.float() if f32 else x


def sigmoid(x, f32: bool = False):
    return 1.0 / _last(1.0 + torch.exp(-x), f32)


def silu(x, f32: bool = False):
    return _last(x, f32) * _last(sigmoid(x), f32)


def softplus(x, f32: bool = False):
    """``jnp.logaddexp(x, 0)``."""
    return (_last(x.clamp_min(0.0), f32)
            + _last(torch.log1p(torch.exp(-x.abs())), f32))


def _const(v: float, dtype) -> float:
    return float(torch.tensor(v, dtype=dtype))


def gelu_tanh(x):
    """``jax.nn.gelu`` with its default ``approximate=True``."""
    inner = x + _const(0.044715, x.dtype) * (x * x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_const((2 / math.pi) ** 0.5, x.dtype)
                                  * inner))
    return x * cdf


# ---------------------------------------------------------------------------
# the depthwise conv and the chunked linear recurrence
# ---------------------------------------------------------------------------


def causal_depthwise_conv(x, w, b, carry: Optional[torch.Tensor] = None):
    """x: (B, S, C); w: (W, C); b: (C,).  Left-padded causal depthwise
    conv; ``carry``: (B, W-1, C), the previous context (decode).  Returns
    (y, the new carry: the last W-1 inputs).  The W taps are added one by
    one in x's dtype, then the bias, as the reference adds them: in bf16
    each sum is rounded (``F.conv1d`` accumulates in f32 and rounds once,
    which differs in about half the outputs)."""
    B, S, C = x.shape
    W = w.shape[0]
    if carry is None:
        carry = x.new_zeros((B, W - 1, C))
    xp = torch.cat([carry.to(x.dtype), x], dim=1)          # (B, S+W-1, C)
    y = x.new_zeros((B, S, C))
    for i in range(W):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return y, (xp[:, S:] if W > 1 else carry)


def scan_chunk(S: int, chunk: int = SCAN_CHUNK) -> int:
    """The reference's chunk rule for a scan over ``S`` positions: chunks
    of ``min(chunk, S)`` that divide ``S`` (it asserts; this raises
    ``ValueError``).  Returns the chunk."""
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"a scan over {S} positions does not split into "
                         f"chunks of {Q}")
    return Q


def _affine_scan(a, b, want_a: bool = True):
    """Inclusive scan along dim 1 of the affine maps h -> a_t * h + b_t:
    ``(a_cum, b_cum)`` with ``b_cum_t = a_t * b_cum_{t-1} + b_t`` (and
    ``a_cum`` the running product; None unless ``want_a``).  Pairwise
    reduction: adjacent pairs are combined, the half-length sequence is
    scanned, and the even positions are filled from it — log2(Q) levels
    of a few batched elementwise ops, no step per position."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a0, a1 = a[:, 0:n - 1:2], a[:, 1::2]
    sa, sb = _affine_scan(a0 * a1, torch.addcmul(b[:, 1::2],
                                                 b[:, 0:n - 1:2], a1))
    m = (n - 1) // 2                      # even positions 2, 4, ... < n
    out_b = torch.empty_like(b)
    out_b[:, :1] = b[:, :1]
    out_b[:, 1::2] = sb
    out_b[:, 2::2] = torch.addcmul(b[:, 2::2], sb[:, :m], a[:, 2::2])
    if not want_a:
        return None, out_b
    out_a = torch.empty_like(a)
    out_a[:, :1] = a[:, :1]
    out_a[:, 1::2] = sa
    out_a[:, 2::2] = sa[:, :m] * a[:, 2::2]
    return out_a, out_b


def chunked_linear_recurrence(h0, S: int, inputs, readout,
                              chunk: int = SCAN_CHUNK, starts=None):
    """h_t = a_t * h_{t-1} + b_t for t < S from ``h0`` (B, ...), f32,
    chunk by chunk under :func:`scan_chunk`'s rule.  ``inputs(c0, c1)``
    gives the chunk's (a, b), each (B, c1 - c0, ...) f32 and made for
    this call (b is written); ``readout(c0, c1, hs)`` maps the chunk's
    states (B, c1 - c0, ...) to its outputs (B, c1 - c0, ...).  Only one
    chunk's tensors and the carried state exist at a time.  ``starts``, a
    list or None, receives the state each chunk starts from.  Returns
    (the outputs concatenated along dim 1, the last state)."""
    Q = scan_chunk(S, chunk)
    h = h0.float()
    ys = []
    for c0 in range(0, S, Q):
        if starts is not None:
            starts.append(h)
        a, b = inputs(c0, c0 + Q)
        b[:, 0].addcmul_(a[:, 0], h)      # the carried state enters here
        hs = _affine_scan(a, b, want_a=False)[1]
        ys.append(readout(c0, c0 + Q, hs))
        h = hs[:, -1].clone()
        del a, b, hs
    return torch.cat(ys, dim=1), h


def _discretised(dtc, uc, Bq, A):
    """One chunk's (a, b) = (exp(dt * A), dt * u * B), each (B, Q, Di, N)
    f32, from its f32 (B, Q, Di) dt and u, (B, Q, N) B and (Di, N) A."""
    a = (dtc[..., None] * A).exp_()
    b = (dtc * uc)[..., None] * Bq[:, :, None, :]
    return a, b


def selective_scan_chunked(u, dt, A, Bc, Cc, h0, *, chunk: int = SCAN_CHUNK,
                           starts=None):
    """u, dt: (B, S, Di); A: (Di, N); Bc, Cc: (B, S, N); h0: (B, Di, N).
    Returns (y (B, S, Di), hT (B, Di, N)), both f32; ``starts`` as
    :func:`chunked_linear_recurrence`'s."""
    A = A.float()

    def inputs(c0, c1):
        return _discretised(dt[:, c0:c1].float(), u[:, c0:c1].float(),
                            Bc[:, c0:c1].float(), A)

    def readout(c0, c1, hs):
        return torch.matmul(hs, Cc[:, c0:c1, :, None].float())[..., 0]

    return chunked_linear_recurrence(h0, u.shape[1], inputs, readout,
                                     chunk, starts)


class SelectiveScan(torch.autograd.Function):
    """:func:`selective_scan_chunked` with a backward that recomputes one
    chunk at a time; ``mamba_mix`` calls it, served (no graph is
    recorded) or trained.  The forward runs the chunked scan as it is
    (the same bits) and saves the inputs and the (B, Di, N) f32 state
    each chunk starts from.  The backward walks the chunks in
    reverse: it rebuilds the chunk's (a, b) and states from its start
    state, runs the adjoint recurrence
        g_t = a_{t+1} * g_{t+1} + C_t * dy_t   (g: the gradient on h_t)
    with the same pairwise scan on the reversed chunk, seeded by the
    gradient carried from the chunk after it (dhT for the last), and
    reduces the chunk's share of du, ddt, dA, dB and dC; the gradient on
    the chunk's start state, a_0 * g_0, is carried to the chunk before
    it, and is dh0 after the first.  Only one chunk's (B, Q, Di, N)
    tensors exist at a time, in the forward and in the backward: the
    backward's peak is the reverse scan's, with the chunk's states and
    the reversed (a, C * dy) live beside the scan's levels (a itself is
    dropped once reversed), under 7 such tensors with the (B, S, Di)
    gradients."""

    @staticmethod
    def forward(ctx, u, dt, A, Bc, Cc, h0):
        starts = []
        with record_function(SCAN_RANGES[0]):
            y, hT = selective_scan_chunked(u, dt, A, Bc, Cc, h0,
                                           starts=starts)
        ctx.save_for_backward(u, dt, A, Bc, Cc, *starts)
        ctx.h0_dtype = h0.dtype
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        with record_function(SCAN_RANGES[1]):
            return SelectiveScan._backward(ctx, dy, dhT)

    @staticmethod
    def _backward(ctx, dy, dhT):
        u, dt, A, Bc, Cc, *starts = ctx.saved_tensors
        B, S, Di = u.shape
        Q = scan_chunk(S)
        A32 = A.float()
        f32 = dict(dtype=torch.float32, device=u.device)
        du, ddt = torch.empty((B, S, Di), **f32), torch.empty((B, S, Di),
                                                              **f32)
        dBc, dCc = (torch.empty(Bc.shape, **f32) for _ in range(2))
        dA = torch.zeros(A.shape, **f32)
        g = dhT.float()                   # the gradient on the chunk's end
        # position s of the reversed chunk takes a_{Q-s} (a_Q := 1)
        rev = torch.arange(Q, 0, -1, device=u.device) % Q
        for c0 in reversed(range(0, S, Q)):
            c1, h = c0 + Q, starts[c0 // Q]
            dtc, uc = dt[:, c0:c1].float(), u[:, c0:c1].float()
            Bq, Cq = Bc[:, c0:c1].float(), Cc[:, c0:c1].float()
            dyq = dy[:, c0:c1].float()
            a, b = _discretised(dtc, uc, Bq, A32)
            b[:, 0].addcmul_(a[:, 0], h)
            hs = _affine_scan(a, b, want_a=False)[1]
            del b
            dCc[:, c0:c1] = torch.matmul(hs.transpose(-1, -2),
                                         dyq[..., None])[..., 0]
            # the adjoint recurrence on the reversed chunk: r_s = g_{Q-1-s}
            # = ar_s * r_{s-1} + (C * dy)_{Q-1-s}, from r_{-1} = g
            a0 = a[:, 0].clone()
            ar = a.index_select(1, rev)
            del a
            ar[:, 0] = 1.0
            gr = dyq.flip(1)[..., None] * Cq.flip(1)[:, :, None, :]
            gr[:, 0] += g
            r = _affine_scan(ar, gr, want_a=False)[1]
            del gr
            # d(dt * u) and dB from g (reversed, as r holds it)
            dtu = torch.matmul(r, Bq.flip(1)[..., None])[..., 0].flip(1)
            dBc[:, c0:c1] = torch.matmul(
                r.transpose(-1, -2),
                (dtc * uc).flip(1)[..., None])[..., 0].flip(1)
            # a_t * g_t, the gradient through h_t = a_t * h_{t-1} + b_t,
            # is ar_{s+1} * r_s (s = Q-1-t), and a_0 * r_{Q-1} for t = 0
            r[:, :-1] *= ar[:, 1:]
            r[:, -1] *= a0
            del ar
            g = r[:, -1].clone()          # the gradient on the start state
            P = r.flip(1)
            del r
            P[:, 1:] *= hs[:, :-1]        # ... times h_{t-1}: da_t * a_t
            P[:, 0] *= h
            del hs
            ddt[:, c0:c1] = (P * A32).sum(-1) + dtu * uc
            dA += P.mul_(dtc[..., None]).sum((0, 1))
            del P
            du[:, c0:c1] = dtu * dtc
        return (du.to(u.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
                dBc.to(Bc.dtype), dCc.to(Cc.dtype), g.to(ctx.h0_dtype))


def _in_proj(x, w, ctx):
    """x @ ``in_proj``, its columns [u | z] of this rank's channels:
    under a mesh ``w`` holds the reference's shard, and the product's
    columns are exchanged over "model"."""
    dt_ = x.dtype
    if ctx is None or ctx.M == 1:
        return x @ w.to(dt_)
    return uz_exchange(copy_to_model(x, ctx) @ w.to(dt_), ctx)


def mamba_mix(p, x, cfg, cache=None):
    """One mamba mixer.  x: (B, S, D) -> (B, S, D); ``p`` holds one
    layer's weights.  ``cache``: {"conv": (B, W-1, Di) in the compute
    dtype, "h": (B, Di, N) f32} or None; written in place.  Under a
    mesh (the installed context) ``p`` holds this rank's shards, Di its
    channels (the module doc)."""
    B, S, _ = x.shape
    N, R = cfg.ssm_state, cfg.ssm_dt_rank
    Di = p["conv_b"].shape[-1]
    ctx = current_ctx()
    dt_ = x.dtype
    u, z = _in_proj(x, p["in_proj"], ctx).split(Di, dim=-1)
    u, new_conv = causal_depthwise_conv(
        u, p["conv_w"].to(dt_), p["conv_b"],
        cache["conv"] if cache is not None else None)
    # the skip term reads u as f32, unrounded (see the activations above)
    u32 = silu(u, f32=True)
    u = u32.to(dt_)
    proj = u @ p["x_proj"].to(dt_)
    if ctx is not None and ctx.M > 1:
        # row-parallel: the partial sums over "model", then every rank's
        # channels read all of it (their gradients summed back)
        proj = copy_to_model(reduce_model(proj, ctx), ctx)
    dtr, Bc, Cc = proj.split([R, N, N], dim=-1)
    dt = softplus(dtr @ p["dt_proj"].to(dt_) + p["dt_bias"].to(dt_))
    A = -torch.exp(p["A_log"].float())
    h0 = (cache["h"] if cache is not None
          else x.new_zeros((B, Di, N), dtype=torch.float32))
    y, hT = SelectiveScan.apply(u, dt, A, Bc, Cc, h0)
    y = (y + u32 * p["D"].float()).to(dt_)
    y = y * silu(z)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(hT)
    return reduce_model(y @ p["out_proj"].to(dt_), ctx)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _params(shapes: dict, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.zeros(s, dtype=torch.float32, device=device))
        for k, s in shapes.items()})


class RecurrentLM(LanguageModel):
    """The embedding and the final norm of the recurrent LMs, and the
    model API (``transformer.LanguageModel``); a subclass names its
    layers' leaves (``_block_shapes``, ``param_shardings``), builds them
    from :meth:`_local_params` and runs them in :meth:`_backbone`.
    Under a mesh (``ctx``) the embedding is vocab-parallel over "model"
    and each layer leaf this rank's shard, its layout the shared one of
    ``LanguageModel``."""

    #: the config family a subclass builds
    family = ""

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device="cuda", ctx: Optional[ShardCtx] = None):
        super().__init__()
        if (cfg.family != self.family or cfg.frontend
                or not cfg.tie_embeddings):
            raise NotImplementedError(
                f"{cfg.name}: {type(self).__name__} builds the "
                f"{self.family!r} family without a modality frontend, "
                f"with tied embeddings")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run = run
        self.dtype = _DTYPES[cfg.dtype]
        self.ctx = ctx
        if ctx is not None:
            self._check_mesh(ctx)
        #: each leaf's full (stacked) shape, by path
        self.full_shapes = {"embed": (cfg.padded_vocab, cfg.d_model),
                            "final_norm": (cfg.d_model,)}
        self.full_shapes.update(self._block_shapes())
        self._mesh_layout()
        self.embed = nn.Parameter(torch.zeros(
            self._local_shape("embed"), dtype=torch.float32,
            device=self.device))
        self.final_norm = nn.Parameter(torch.zeros(
            (cfg.d_model,), dtype=torch.float32, device=self.device))

    def _block_shapes(self) -> dict:
        """{path: full stacked shape} of every layer leaf."""
        raise NotImplementedError

    def _local_params(self, prefix: str, names) -> nn.ParameterDict:
        """The Parameters ``prefix + name`` of ``names``, each this
        rank's shard."""
        return _params({k: self._local_shape(prefix + k) for k in names},
                       self.device)

    def _layer_specs(self, prefix: str, specs: dict) -> dict:
        """One layer's specs behind a leading None (the stacked axis),
        by path under ``prefix``."""
        return {prefix + k: (None,) + v for k, v in specs.items()}

    def param_shardings(self) -> dict:
        """Each leaf's spec, by path: the embedding vocab-parallel over
        "model" (the reference's ``P("model", None)``), the final norm
        replicated, the layers' (``_layers_shardings``)."""
        out = {"embed": (("model", self.cfg.padded_vocab), None),
               "final_norm": (None,)}
        out.update(self._layers_shardings())
        return out

    def _init_shared(self, generator: torch.Generator) -> None:
        self.embed.copy_(L.init_normal(
            generator, self.full_shapes["embed"], 0.02,
            self.device)[self.shard_index("embed")])
        self.final_norm.zero_()

    def _remat(self) -> bool:
        return (self.run is not None and self.run.remat != "none"
                and torch.is_grad_enabled())

    def _call(self, layer, remat: bool, x, *args):
        """``layer(x, *args)`` under the model's context, recomputed in
        the backward under remat (every rank recomputes each layer whole,
        its collectives included, in the same order)."""
        def run(*a):
            with use_shard_ctx(self.ctx):
                return layer(*a)
        if remat:
            with set_checkpoint_early_stop(self.ctx is None):
                return checkpoint(run, x, *args, use_reentrant=False)
        return run(x, *args)


class MambaLM(RecurrentLM):
    """Attention-free mamba-1 LM: one stacked ``slot0`` of n_layers
    mamba layers, ``blocks/slot0/{A_log, D, conv_b, conv_w, dt_bias,
    dt_proj, in_proj, norm, out_proj, x_proj}`` each (n_layers, ...)."""

    family = "ssm"

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device="cuda", ctx: Optional[ShardCtx] = None):
        super().__init__(cfg, run, device, ctx)
        self.n_groups = cfg.n_layers
        self.blocks = nn.ModuleDict({"slot0": self._local_params(
            "blocks/slot0/", ssm_layer_shapes(cfg))})

    def _check_mesh(self, ctx: ShardCtx) -> None:
        """The mesh splits d_inner and the vocabulary evenly over
        "model": anything else raises (no fall back)."""
        self._check_divides(ctx, {"d_inner": self.cfg.d_inner,
                                  "padded vocab": self.cfg.padded_vocab})

    def _block_shapes(self) -> dict:
        return {f"blocks/slot0/{k}": (self.cfg.n_layers,) + s
                for k, s in ssm_layer_shapes(self.cfg).items()}

    def _layers_shardings(self) -> dict:
        return self._layer_specs("blocks/slot0/", ssm_layer_shardings())

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The reference's distributions: ``A_log`` rows log(1..N), ``D``
        ones, ``conv_b`` / ``dt_bias`` / ``norm`` zeros, every other leaf
        N(0, 1) / sqrt(shape[0]) of its per-layer shape, drawn one layer
        at a time (under a mesh each slice whole, this rank's shard
        kept: the shards equal the unsharded model's of the generator)."""
        N = self.cfg.ssm_state
        for k, p in self.blocks["slot0"].items():
            path = "blocks/slot0/" + k
            if k == "A_log":
                p.copy_(torch.log(torch.arange(
                    1, N + 1, dtype=torch.float32, device=p.device))
                    .expand(p.shape))
            elif k == "D":
                p.fill_(1.0)
            elif k in ("conv_b", "dt_bias", "norm"):
                p.zero_()
            else:
                self._draw_leaf(path, p, generator,
                                self.full_shapes[path][1] ** -0.5)
        self._init_shared(generator)

    def param_tree(self) -> dict:
        return {"blocks": {"slot0": dict(self.blocks["slot0"])},
                "embed": self.embed, "final_norm": self.final_norm}

    def init_cache(self, B: int, S: int) -> dict:
        """Zeroed per-layer caches for ``B`` sequences (their size does not
        depend on ``S``): the conv carry in the compute dtype, the scan
        state in f32 (under a mesh: this rank's batch block and
        channels)."""
        cfg, n = self.cfg, self.n_groups
        B, Di = self._cache_batch(B), self.blocks["slot0"]["conv_b"].shape[-1]
        return {"slot0": {
            "conv": torch.zeros((n, B, cfg.ssm_conv - 1, Di),
                                dtype=self.dtype, device=self.device),
            "h": torch.zeros((n, B, Di, cfg.ssm_state),
                             dtype=torch.float32, device=self.device)}}

    def _layer(self, names, fsdp, cache, x, *w):
        p = dict(zip(names, self._gathered(w, fsdp)))
        h = L.rms_norm(x, p["norm"], self.cfg.rms_eps)
        return x + mamba_mix(p, h, self.cfg, cache)

    def _backbone(self, x, positions, caches=None, cache_len=None):
        remat = self._remat()
        names, per_layer = unstack(dict(self.blocks["slot0"]))
        fsdp = self._fsdp_dims("blocks/slot0/", names)
        for i, w in enumerate(per_layer):
            cache = (None if caches is None else
                     {k: c[i] for k, c in caches["slot0"].items()})
            x = self._call(partial(self._layer, names, fsdp, cache), remat,
                           x, *w)
        return L.rms_norm(x, self.final_norm, self.cfg.rms_eps)
