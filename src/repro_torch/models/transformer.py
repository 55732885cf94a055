"""Decoder-only transformer LMs — port of ``repro/models/transformer.py``
as ``nn.Module``s: the dense stack (paper-350m, qwen3, minitron,
starcoder2; llava-next-mistral-7b, whose vision stub puts ``n_patches``
precomputed patch embeddings before the tokens) and gemma2's
alternating local / global layers, with
qk-norm, post-norms, logit softcaps and the sqrt(d) embedding scale where
the config asks for them; and :class:`MoETransformer` (qwen3-moe,
dbrx), the same stack with each layer's FFN a capacity-dispatch
mixture of experts (``models/moe.py``).

The parameters keep the reference's tree and stacked layout: layers are
grouped into repeating *groups* — ``"global"``: one slot x L groups,
``"local_global"``: (local, global) x L/2 — and each slot's weights carry
a leading ``(n_groups, ...)`` axis, beside the embedding and the final
norm, so the sorted-key leaf order (and hence the sync groups and plans)
match the reference.  The FFN's leaves, init and apply are the
reference's hooks (``_ffn_shapes`` / ``_ffn_init`` / ``_ffn_apply``).
Compute is bf16 on f32 master weights (or bf16 weights, for serving);
each layer is recomputed in the backward pass when the run asks for
remat ("minimal" or "full": ``torch.utils.checkpoint``).

Serving: :meth:`DenseTransformer.prefill` fills ring KV caches
(:meth:`~DenseTransformer.init_cache`: one ``(n_groups, B, S, KV, Dh)``
stack per slot and k / v, a local slot's S capped at the sliding window)
and :meth:`~DenseTransformer.decode_step` writes one token into them in
place.

Under a ("data", "model") mesh (``ctx``, a ``ShardCtx``) each Parameter
holds this rank's shard of its stacked leaf, as
:meth:`DenseTransformer.param_shardings` names it (the layers' specs
behind a leading None; the embedding vocab-parallel over "model"): the
model takes the global batch and keeps its "data" block (all of it where
D does not divide B), gathers each FSDP-sharded weight over "data" just
before its layer (freed after), and returns vocab-sharded logits of its
batch block.  The ring caches hold the block's sequences and this rank's
K/V heads.

Training under a mesh differentiates through those collectives
(``models/shardctx.py``): the FSDP gather's gradient is reduce-scattered
over "data", a remat layer re-issues its forward collectives in the
backward (every rank recomputes the same layers in the same order, the
context re-installed around each), and :meth:`LanguageModel.loss` is the
mean over the global batch, each rank's gradient its batch block's part
of it.  :meth:`LanguageModel.reduce_grads` then sums the gradients of
the leaves that a rank computes only in part: over "data" every leaf that
is not FSDP-sharded, over "model" the qk-norms and the router.  These
layout methods live on :class:`LanguageModel`, driven by a model's
``full_shapes`` and ``param_shardings()``, so the recurrent families
(``models/mamba.py``, ``models/rglru.py``) and the encoder-decoder
(``models/encdec.py``) shard, train and checkpoint through the same
code.  The VLM's patch embeddings are blocked over "data" with the
tokens.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.shardctx import (ShardCtx, gather_data,
                                        use_shard_ctx)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
_GROUP_KINDS = {"global": ("global",), "local_global": ("local", "global")}


def _norm_names(cfg: ModelConfig) -> tuple:
    """A slot's norms: the pre-norms, and gemma2's post-norms."""
    return ("ln1", "ln2") + (("ln1_post", "ln2_post") if cfg.post_norms
                             else ())


class _Slot(nn.Module):
    """One stacked layer slot: attention (with qk-norm weights where the
    config asks) and FFN weights (``ffn_shapes``) plus the pre-norms (and
    gemma2's post-norms), each with a leading (n_groups, ...) axis."""

    def __init__(self, cfg: ModelConfig, n: int, device, attn_shapes: dict,
                 ffn_shapes: dict):
        super().__init__()

        def par(shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=device))

        self.attn = nn.ParameterDict(
            {k: par(s) for k, s in attn_shapes.items()})
        self.ffn = nn.ParameterDict(
            {k: par(s) for k, s in ffn_shapes.items()})
        self.norms = _norm_names(cfg)
        for k in self.norms:
            setattr(self, k, par((n, cfg.d_model)))

    def tree(self) -> dict:
        out = {"attn": dict(self.attn), "ffn": dict(self.ffn)}
        out.update({k: getattr(self, k) for k in self.norms})
        return out


def _draw(p: torch.Tensor, generator: torch.Generator, std: float,
          shard=None):
    """Fill the stacked leaf ``p`` (n_groups, ...) with N(0, std^2) one
    slice of its leading axis at a time, each drawn in f32 and copied in
    in ``p``'s dtype: no f32 temporary is larger than one slice.
    ``shard`` = (the leaf's full shape, the index of ``p`` in it) for a
    rank's shard: each slice is drawn whole, from the stream the
    unsharded leaf draws, and the shard's part of it kept."""
    shape, index = (p.shape, ()) if shard is None else (shard[0],
                                                        shard[1][1:])
    for s in p:
        s.copy_(L.init_normal(generator, shape[1:], std, p.device)[index])


def unstack(tree: dict):
    """(the leaves' paths in ``tree``, each layer's leaves): every stacked
    (n, ...) leaf is sliced once — the backward of one unbind stacks the
    per-layer grads in a single pass, where indexing the stack per layer
    would fill and add a full-stack gradient per layer (quadratic in
    depth)."""
    paths, stacks = zip(*T.leaves_with_path(tree))
    return ([T.path_str(q) for q in paths],
            list(zip(*(w.unbind(0) for w in stacks))))


class LanguageModel(nn.Module):
    """The model API the port's LMs share, around a subclass's
    ``param_tree()``, ``init_cache(B, S)`` and ``_backbone(x, positions,
    caches=None, cache_len=None)`` (the layer stack and the final norm;
    the caches written in place), and its ``embed``, ``cfg``, ``dtype``:
    ``forward`` / ``loss`` / ``logits`` for training, ``prefill`` /
    ``decode_step`` for serving.

    The model inputs are the reference's (``input_specs``): tokens, and
    for a model behind a frontend stub its float inputs too, named in
    ``float_inputs`` and shaped by ``frontend_shapes`` — the VLM's
    ``patch_embs``, put as ``n_prefix`` positions before the tokens, or
    the encoder-decoder's ``frames``.  A batch carries them under those
    names; ``forward`` and ``prefill`` take them as keywords."""

    #: positions a frontend stub puts before the tokens
    n_prefix = 0
    #: the ("data", "model") mesh the Parameters are sharded over (None:
    #: each holds its whole leaf)
    ctx: Optional[ShardCtx] = None
    #: the float inputs a batch carries besides tokens and labels
    float_inputs = ()

    def param_shapes(self) -> dict:
        return T.tree_map(lambda p: tuple(p.shape), self.param_tree())

    def active_param_count(self) -> int:
        """N of ``flops.model_flops``, counted from the tree: the
        parameters one token runs through (on a mesh rank, of the whole
        model: its leaves' global shapes, so each rank's MFU counts the
        model the mesh runs)."""
        if self.ctx is None:
            return sum(p.numel() for p in self.parameters())
        return sum(math.prod(s) for s in self.full_shapes.values())

    # ---------------- inputs ----------------
    def frontend_shapes(self, B: int, S: int) -> dict:
        """{name: shape} of the float inputs for ``B`` sequences of ``S``
        tokens (none for a token-only model)."""
        return {}

    def text_len(self, shape: ShapeConfig) -> int:
        """The tokens of one sequence of ``shape`` (its positions less
        the frontend's, but for decode)."""
        if shape.kind == "decode":
            return shape.seq_len
        return shape.seq_len - self.n_prefix

    def input_specs(self, shape: ShapeConfig) -> dict:
        """The reference's model inputs for ``shape``: {name: (shape,
        dtype)} — ``tokens`` (B, text_len) int32, ``labels`` (B,
        seq_len) for training, the float inputs (f32) but for decode, and
        (B, 1) tokens alone for decode."""
        B = shape.global_batch
        if shape.kind == "decode":
            return {"tokens": ((B, 1), torch.int32)}
        S = self.text_len(shape)
        specs = {"tokens": ((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((B, shape.seq_len), torch.int32)
        specs.update({k: (d, torch.float32)
                      for k, d in self.frontend_shapes(B, S).items()})
        return specs

    def _embed(self, tokens, patch_embs=None):
        """The token embeddings of this rank's batch block of ``tokens``
        (all of it without a mesh), after its block of the patch
        embeddings (cast to the compute dtype) where given."""
        x = L.embed_lookup(self.embed, self._local_batch(tokens), self.cfg,
                           self.dtype)
        if patch_embs is not None:
            x = torch.cat([self._local_batch(patch_embs).to(self.dtype), x],
                          dim=1)
        return x

    def forward(self, tokens: torch.Tensor,
                patch_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) (after ``patch_embs`` (B, P, D) where given) ->
        final hidden states (B, P + S, D) in the compute dtype (under a
        mesh, of this rank's batch block)."""
        with use_shard_ctx(self.ctx):
            x = self._embed(tokens, patch_embs)
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            return self._backbone(x, positions)

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean cross-entropy over every position of the batch (the
        VLM's patch positions too, against the pipeline's label 0, as
        the reference scores them: ROADMAP R9).  Under a mesh: the mean
        over the global batch, the same value on every rank, whose
        gradient on each rank is its batch block's part — 1 / D of its
        block's mean (where D does not divide the batch, each data rank's
        block is the whole batch, and the data ranks' gradients, summed
        by the FSDP reduce-scatter and :meth:`reduce_grads`, average)."""
        x = self.forward(batch["tokens"], **{k: batch[k] for k in
                                             self.float_inputs if k in batch})
        with use_shard_ctx(self.ctx):
            local = L.xent_loss_chunked(x, self.embed,
                                        self._local_batch(batch["labels"]),
                                        self.cfg)
        ctx = self.ctx
        if ctx is None or ctx.D == 1:
            return local
        split = ctx.batch_slice(batch["labels"].shape[0]) != slice(
            0, batch["labels"].shape[0])
        with torch.no_grad():
            value = (ctx.all_reduce_sum(local * (1.0 / ctx.D), "data")
                     if split else local.clone())
        return _GlobalLoss.apply(local, value, 1.0 / ctx.D)

    def _cache_batch(self, B: int) -> int:
        """The sequences of a batch of ``B`` this rank's caches hold (its
        "data" block)."""
        return B if self.ctx is None else len(range(B)[
            self.ctx.batch_slice(B)])

    def _local_batch(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's "data" block of a global batch (all of it without
        a mesh)."""
        return t if self.ctx is None else t[self.ctx.batch_slice(
            t.shape[0])]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """LM-head logits (final softcap included) of hidden states
        (under a mesh, this rank's vocabulary part)."""
        return L.lm_logits(x, self.embed.to(x.dtype), self.cfg)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                patch_embs: Optional[torch.Tensor] = None):
        """tokens (B, S) (after ``patch_embs`` (B, P, D) where given) ->
        (the last position's logits (B, 1, V), the caches
        (:meth:`init_cache` of ``cache_len``, default P + S positions)
        holding the prompt).  Decode goes on at position P + S.  Under a
        mesh, the logits and caches of this rank's batch block, the
        logits its vocabulary part."""
        with use_shard_ctx(self.ctx):
            x = self._embed(tokens, patch_embs)
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            caches = self.init_cache(tokens.shape[0], cache_len or S)
            x = self._backbone(x, positions, caches=caches)
            return self.logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, caches: dict, cache_len: int,
                    tokens: torch.Tensor):
        """tokens (B, 1) at position ``cache_len`` (the count of positions
        already in the caches) -> (logits (B, 1, V), the caches, written
        in place); under a mesh, as :meth:`prefill`."""
        t = int(cache_len)
        with use_shard_ctx(self.ctx):
            x = L.embed_lookup(self.embed, self._local_batch(tokens),
                               self.cfg, self.dtype)
            positions = torch.full((x.shape[0], 1), t, device=x.device)
            x = self._backbone(x, positions, caches=caches, cache_len=t)
            return self.logits(x), caches


    # ---------------- the layout on a ("data", "model") mesh ----------------
    #: leaves (by the last part of their path) that every "model" rank
    #: holds whole but computes its gradient of only in part: the
    #: qk-norms over its heads, the MoE router over its tokens
    MODEL_PARTIAL = ("q_norm", "k_norm", "router")

    def _check_divides(self, ctx: ShardCtx, need: dict) -> None:
        """Raise ``ValueError`` unless "model" divides each of ``need``
        ({what: count}): the mesh splits them evenly or not at all (no
        fall back)."""
        bad = {k: v for k, v in need.items() if v % ctx.M}
        if bad:
            raise ValueError(f"{self.cfg.name}: model = {ctx.M} does not "
                             f"divide its {bad}")

    def _mesh_layout(self) -> None:
        """After ``full_shapes`` (each leaf's whole shape, by path) is
        set: the specs (``param_shardings()``) and the stacked leaves
        FSDP-sharded over "data" (``_fsdp``: path -> the dimension of one
        layer's slice to gather)."""
        ctx = self.ctx
        self._specs = self.param_shardings()
        self._fsdp = {}
        if ctx is not None and ctx.D > 1:
            for path, spec in self._specs.items():
                dims = [j for j, ax in enumerate(spec) if ax == "data"
                        and self.full_shapes[path][j] % ctx.D == 0]
                # a stacked leaf: its leading (layer) axis whole, one
                # layer's slice gathered just before the layer
                if dims and len(spec) > 1 and spec[0] is None:
                    self._fsdp[path] = dims[0] - 1

    def _local_shape(self, path: str) -> tuple:
        full = self.full_shapes[path]
        return full if self.ctx is None else self.ctx.local_shape(
            self._specs[path], full)

    def shard_index(self, path: str) -> tuple:
        """The index of this rank's Parameter ``path`` in the full leaf
        (whole slices without a mesh)."""
        full = self.full_shapes[path]
        if self.ctx is None:
            return tuple(slice(None) for _ in full)
        return self.ctx.local_index(self._specs[path], full)

    def _draw_leaf(self, path: str, p, generator, std: float) -> None:
        _draw(p, generator, std, (self.full_shapes[path],
                                  self.shard_index(path)))

    def _fsdp_dims(self, prefix: str, names) -> list:
        """The FSDP dimension (None: whole) of each leaf ``prefix + name``
        of one layer."""
        return [self._fsdp.get(prefix + k) for k in names]

    def _gathered(self, w, fsdp) -> list:
        """One layer's weights, each FSDP-sharded one gathered over
        "data" (its gradient reduce-scattered back)."""
        return [t if dim is None else gather_data(t, dim, self.ctx)
                for t, dim in zip(w, fsdp)]

    def _layer_tree(self, names, fsdp, w) -> dict:
        """One layer's weights ``w`` (paths ``names``) as a tree, each
        FSDP-sharded one gathered over "data"."""
        return T.from_flat_dict(dict(zip(names, self._gathered(w, fsdp))))

    def _in_ctx(self, layer, *args):
        """``layer(*args)`` under the model's context: a remat layer's
        recompute runs in the backward, where none is installed."""
        with use_shard_ctx(self.ctx):
            return layer(*args)

    def global_param_shapes(self) -> dict:
        """Each leaf's whole shape (under a mesh, not this rank's
        shard's)."""
        if self.ctx is None:
            return self.param_shapes()
        return T.from_flat_dict({T.path_str(q): self.full_shapes[
            T.path_str(q)] for q, _ in T.leaves_with_path(self.param_tree())})

    def check_reference_shards(self) -> None:
        """Raise ``ValueError`` naming the first leaf whose shard on this
        rank is not the reference's local shard on the same mesh (its
        nested manual region divides each spec'd dimension by its axis'
        size): the sync round runs on the shards, so a different layout
        would be a different sync."""
        ctx = self.ctx
        if ctx is None:
            return
        for path, spec in self._specs.items():
            full = self.full_shapes[path]
            want = tuple(n // ctx.sizes[ax[0] if isinstance(ax, tuple)
                                        else ax] if ax else n
                         for n, ax in zip(full, spec))
            got = ctx.local_shape(spec, full)
            if got != want:
                raise ValueError(
                    f"{self.cfg.name}: leaf {path}: this rank's shard "
                    f"{got} of {full} is not the reference's local shard "
                    f"{want} on a ({ctx.D}, {ctx.M}) mesh; training "
                    f"refuses a sync layout other than the reference's")

    def _replicas(self, path: str) -> list:
        """The ranks that hold the same shard of leaf ``path`` as this
        one, in rank order."""
        ctx = self.ctx
        full, spec = self.full_shapes[path], self._specs[path]
        mine = ctx.local_index(spec, full)
        return [r for r in range(ctx.D * ctx.M)
                if ShardCtx(ctx.D, ctx.M, r // ctx.M, r % ctx.M)
                .local_index(spec, full) == mine]

    def shard_of(self, path: str) -> tuple:
        """(leaf ``path``'s full shape, this rank's index into it, whether
        this rank is the first of the ranks holding that shard: the one
        that counts it in a sum over the whole mesh and writes it to a
        checkpoint)."""
        first = self.ctx is None or self._replicas(path)[0] == self.ctx.rank
        return self.full_shapes[path], self.shard_index(path), first

    def owned_leaves(self) -> list:
        """Per leaf (sorted-key order): whether this rank is the first of
        the ranks holding its shard (:meth:`shard_of`) — the one that
        counts it in a global norm and the grad stats."""
        return [self.shard_of(T.path_str(q))[2] for q, _ in
                T.leaves_with_path(self.param_tree())]

    def grad_reduce_axes(self, path: str) -> tuple:
        """The axes over which the gradient of leaf ``path`` is summed
        after the backward: "data" where it is not FSDP-sharded (each data
        rank saw its own batch block), "model" for the leaves every model
        rank holds but computes its gradient of in part
        (``MODEL_PARTIAL``).  Experts every model rank holds (M not
        dividing E) would be such leaves too; the reference splits them,
        so that mesh does not train (:meth:`check_reference_shards`)."""
        ctx = self.ctx
        if ctx is None:
            return ()
        axes = []
        if ctx.D > 1 and path not in self._fsdp:
            axes.append("data")
        if ctx.M > 1 and path.rsplit("/", 1)[-1] in self.MODEL_PARTIAL:
            axes.append("model")
        return tuple(axes)

    def reduce_grads(self, grads: list) -> list:
        """The gradients of the leaves (sorted-key order) summed over the
        axes :meth:`grad_reduce_axes` names: each rank's becomes its shard
        of the gradient of the global loss."""
        if self.ctx is None:
            return list(grads)
        # a shard other than the reference's (experts replicated over the
        # ranks that share them) would need its gradient summed over them
        # too: such a mesh does not train
        self.check_reference_shards()
        paths = [T.path_str(q) for q, _ in
                 T.leaves_with_path(self.param_tree())]
        out = []
        for path, g in zip(paths, grads):
            axes = self.grad_reduce_axes(path)
            if axes:
                g = self.ctx.all_reduce_sum(
                    g, "world" if len(axes) == 2 else axes[0])
            out.append(g)
        return out


class _GlobalLoss(torch.autograd.Function):
    """``value`` (the global loss, the same on every rank) forward; the
    gradient of ``local`` (this rank's block's loss) times ``scale``
    backward."""

    @staticmethod
    def forward(fctx, local, value, scale):
        fctx.scale = scale
        return value.clone()

    @staticmethod
    def backward(fctx, g):
        return g * fctx.scale, None, None


class DenseTransformer(LanguageModel):
    """Dense decoder-only LM (the "global" and "local_global" layer
    patterns).  Also the base of the MoE variant."""

    #: the config family this class builds
    family = "dense"

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device="cuda", ctx: Optional[ShardCtx] = None):
        super().__init__()
        if (cfg.family != self.family
                or cfg.layer_pattern not in _GROUP_KINDS
                or cfg.frontend not in (None, "vision_stub")
                or not cfg.tie_embeddings):
            raise NotImplementedError(
                f"{cfg.name}: only the dense and MoE transformers, with "
                f"tied embeddings and no frontend but the vision stub, "
                f"are ported")
        if cfg.frontend == "vision_stub":
            self.n_prefix = cfg.n_patches
            self.float_inputs = ("patch_embs",)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run = run
        self.dtype = _DTYPES[cfg.dtype]
        self.group_kinds = _GROUP_KINDS[cfg.layer_pattern]
        if cfg.n_layers % len(self.group_kinds):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"split into {self.group_kinds} groups")
        self.n_groups = cfg.n_layers // len(self.group_kinds)
        self.q_chunk = run.q_chunk if run else 2048
        self.kv_chunk = run.kv_chunk if run else 1024
        self.ctx = ctx
        if ctx is not None:
            self._check_mesh(ctx)
        n = self.n_groups
        #: each leaf's full (stacked) shape, by path
        self.full_shapes = {"embed": (cfg.padded_vocab, cfg.d_model),
                            "final_norm": (cfg.d_model,)}
        parts = {}
        for i in range(len(self.group_kinds)):
            for part, shapes in (("attn", L.attn_shapes(cfg, n)),
                                 ("ffn", self._ffn_shapes(n))):
                pre = f"blocks/slot{i}/{part}/"
                self.full_shapes.update({pre + k: v
                                         for k, v in shapes.items()})
                parts[i, part] = (pre, shapes)
            self.full_shapes.update({f"blocks/slot{i}/{k}": (n, cfg.d_model)
                                     for k in _norm_names(cfg)})
        self._mesh_layout()
        local = {key: {k: self._local_shape(pre + k) for k in shapes}
                 for key, (pre, shapes) in parts.items()}
        self.blocks = nn.ModuleDict(
            {f"slot{i}": _Slot(cfg, n, self.device, local[i, "attn"],
                               local[i, "ffn"])
             for i in range(len(self.group_kinds))})
        self.embed = nn.Parameter(torch.zeros(
            self._local_shape("embed"), dtype=torch.float32,
            device=self.device))
        self.final_norm = nn.Parameter(torch.zeros(
            (cfg.d_model,), dtype=torch.float32, device=self.device))

    def _check_mesh(self, ctx: ShardCtx) -> None:
        """The mesh splits the heads' H * Dh columns (whole heads or, as
        the reference splits them, parts of heads), d_ff (dense) and the
        vocabulary evenly over "model", and the K/V heads over it or it
        over them: anything else raises (no fall back)."""
        cfg = self.cfg
        need = {"heads x head_dim": cfg.n_heads * cfg.head_dim,
                "padded vocab": cfg.padded_vocab}
        if self.family == "dense":
            need["d_ff"] = cfg.d_ff
        self._check_divides(ctx, need)
        L.kv_heads_local(cfg, ctx)

    def param_shardings(self) -> dict:
        """Each leaf's spec, by path: the layers' (``attn_shardings``,
        the FFN's) behind a leading None for the stacked axis, the norms
        replicated, the embedding vocab-parallel over "model" (the
        reference's ``P("model", None)``)."""
        cfg = self.cfg
        out = {"embed": (("model", cfg.padded_vocab), None),
               "final_norm": (None,)}
        for i in range(len(self.group_kinds)):
            for part, sp in (("attn", L.attn_shardings(cfg)),
                             ("ffn", self._ffn_shardings())):
                out.update({f"blocks/slot{i}/{part}/{k}": (None,) + v
                            for k, v in sp.items()})
            out.update({f"blocks/slot{i}/{k}": (None, None)
                        for k in _norm_names(cfg)})
        return out

    def frontend_shapes(self, B: int, S: int) -> dict:
        if self.cfg.frontend != "vision_stub":
            return {}
        return {"patch_embs": (B, self.cfg.n_patches, self.cfg.d_model)}

    # ---------------- FFN hooks ----------------
    def _ffn_shapes(self, n: int) -> dict:
        return L.mlp_shapes(self.cfg, n)

    def _ffn_shardings(self) -> dict:
        return L.mlp_shardings(self.cfg)

    def _ffn_init(self, pre: str, ffn: nn.ParameterDict,
                  generator: torch.Generator) -> None:
        for k, p in ffn.items():
            self._draw_leaf(pre + k, p, generator,
                            self.full_shapes[pre + k][-2] ** -0.5)

    def _ffn_apply(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return L.mlp_apply(p, x)

    # ---------------- params ----------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random init with the reference's distributions (its RNG stream
        differs: parity runs load the reference's weights instead).  Each
        stacked leaf is drawn slice by slice along its leading axis, in
        f32, and copied into its Parameter in the Parameter's dtype.
        Under a mesh every slice is drawn whole, in the unsharded model's
        order, and this rank's shard kept: a sharded model equals the
        unsharded model of the same generator, shard for shard."""
        for name, slot in self.blocks.items():
            pre = f"blocks/{name}/"
            for k, p in slot.attn.items():
                if k.startswith("w"):
                    full = self.full_shapes[pre + "attn/" + k]
                    self._draw_leaf(pre + "attn/" + k, p, generator,
                                    full[-2] ** -0.5)
                else:
                    p.zero_()
            self._ffn_init(pre + "ffn/", slot.ffn, generator)
            for k in slot.norms:
                getattr(slot, k).zero_()
        self.embed.copy_(L.init_normal(
            generator, self.full_shapes["embed"], 0.02,
            self.device)[self.shard_index("embed")])
        self.final_norm.zero_()

    def param_tree(self) -> dict:
        """The parameters as the reference's nested tree (the tensors are
        this module's own Parameters)."""
        return {"blocks": {k: s.tree() for k, s in self.blocks.items()},
                "embed": self.embed, "final_norm": self.final_norm}

    # ---------------- cache ----------------
    def _slot_cache_shape(self, kind: str, B: int, S: int):
        cfg = self.cfg
        if kind == "local" and cfg.sliding_window:
            S = min(S, cfg.sliding_window)
        kv = L.kv_heads_local(cfg, self.ctx)
        return (self.n_groups, self._cache_batch(B), S, kv, cfg.head_dim)

    def init_cache(self, B: int, S: int) -> dict:
        """Zeroed ring KV caches for ``B`` sequences of up to ``S``
        positions, in the compute dtype (under a mesh: this rank's batch
        block and K/V heads)."""
        return {f"slot{i}": {
            kv: torch.zeros(self._slot_cache_shape(kind, B, S),
                            dtype=self.dtype, device=self.device)
            for kv in ("k", "v")} for i, kind in enumerate(self.group_kinds)}

    # ---------------- forward ----------------
    def _layer(self, kind, names, fsdp, cache, cache_len, x, positions,
               *w):
        """One layer of slot flavour ``kind``; ``w`` are its weights
        sliced out of the stacks, ``names`` their paths in the slot's
        tree, ``fsdp`` the dimension to gather over "data" of each (None:
        whole)."""
        cfg = self.cfg
        p = self._layer_tree(names, fsdp, w)
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
        h = L.attn_apply(
            p["attn"], h, cfg, positions=positions,
            window=cfg.sliding_window if kind == "local" else None,
            cache=cache, cache_len=cache_len, q_chunk=self.q_chunk,
            kv_chunk=self.kv_chunk)
        if cfg.post_norms:
            h = L.rms_norm(h, p["ln1_post"], cfg.rms_eps)
        x = x + h
        h = self._ffn_apply(p["ffn"], L.rms_norm(x, p["ln2"], cfg.rms_eps))
        if cfg.post_norms:
            h = L.rms_norm(h, p["ln2_post"], cfg.rms_eps)
        return x + h

    def _backbone(self, x, positions, caches=None, cache_len=None):
        """The layer stack, group by group (each group's slots in order),
        then the final norm.  ``caches`` (from :meth:`init_cache`) are
        written in place."""
        remat = (self.run is not None and self.run.remat != "none"
                 and torch.is_grad_enabled())
        slots = []
        for i, kind in enumerate(self.group_kinds):
            names, per_layer = unstack(self.blocks[f"slot{i}"].tree())
            fsdp = self._fsdp_dims(f"blocks/slot{i}/", names)
            slots.append((kind, names, fsdp, per_layer))
        for g in range(self.n_groups):
            for i, (kind, names, fsdp, per_layer) in enumerate(slots):
                cache = None
                if caches is not None:
                    cache = {kv: c[g] for kv, c in caches[f"slot{i}"].items()}
                layer = partial(self._in_ctx, self._layer, kind, names,
                                fsdp, cache, cache_len)
                if remat:
                    # under a mesh every rank recomputes each layer whole,
                    # its collectives included, in the same order
                    with set_checkpoint_early_stop(self.ctx is None):
                        x = checkpoint(layer, x, positions, *per_layer[g],
                                       use_reentrant=False)
                else:
                    x = layer(x, positions, *per_layer[g])
        return L.rms_norm(x, self.final_norm, self.cfg.rms_eps)


class MoETransformer(DenseTransformer):
    """The dense transformer with each layer's FFN a capacity-dispatch
    mixture of experts (``models/moe.py``): the slot's ``ffn`` holds the
    ``router`` (n, D, E) and the expert stacks ``w_gate`` / ``w_up``
    (n, E, D, Fe) and ``w_down`` (n, E, Fe, D)."""

    family = "moe"

    def _ffn_shapes(self, n: int) -> dict:
        return moe.moe_shapes(self.cfg, n)

    def _ffn_shardings(self) -> dict:
        return moe.moe_shardings(self.cfg)

    def _ffn_init(self, pre: str, ffn: nn.ParameterDict,
                  generator: torch.Generator) -> None:
        for k, p in ffn.items():
            self._draw_leaf(pre + k, p, generator,
                            moe.init_std(k, self.full_shapes[pre + k]))

    def _ffn_apply(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return moe.moe_apply(p, x, self.cfg)

    def active_param_count(self) -> int:
        """The tree's count less the experts a token is not routed to."""
        cfg = self.cfg
        idle = (cfg.n_experts - cfg.experts_per_token) * 3 * cfg.d_model \
            * cfg.d_ff
        return super().active_param_count() - cfg.n_layers * idle
