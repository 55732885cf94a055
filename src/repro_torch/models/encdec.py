"""Encoder-decoder transformer (seamless-m4t-medium) — port of
``repro/models/encdec.py`` as an ``nn.Module``.

The audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings ``frames`` (B, F, d_model), F =
``max(64, S // audio_downsample)`` for S tokens (:meth:`frames_len`).
The encoder runs them through ``n_enc_layers`` bidirectional layers
(self-attention with RoPE, the SwiGLU MLP) and a final norm; the decoder
is a causal transformer whose layers add a cross-attention over the
encoder's output between self-attention and the MLP.  The LM head is the
tied embedding.

The parameters keep the reference's tree, in its sorted-key leaf order:
``dec_blocks/{cross_attn, ffn, ln1, ln2, ln3, self_attn}``, ``embed``,
``enc_blocks/{attn, ffn, ln1, ln2}``, ``enc_norm``, ``final_norm``, each
block leaf stacked on a leading layer axis.  Compute is bf16 on f32
master weights (or bf16 weights, for serving); each layer is recomputed
in the backward pass when the run asks for remat.

Serving: :meth:`EncDecTransformer.prefill` encodes the frames, runs the
prompt and fills the caches (:meth:`~EncDecTransformer.init_cache`):
``self`` ring KV caches of the decoder's self-attention and ``cross``,
each layer's keys and values of the encoder's output, written once;
:meth:`~LanguageModel.decode_step` writes one token into the ``self``
caches in place and reads ``cross``.

Under a ("data", "model") mesh (``ctx``) each Parameter holds this rank's
shard of its leaf as the reference's ``param_shardings`` names it: the
encoder's attention, the decoder's self- and cross-attention and both
FFNs as the dense stack shards them (``attn_shardings`` /
``mlp_shardings``: column-parallel over "model", row-parallel out, FSDP
over "data", gathered layer by layer), the embedding vocab-parallel, the
norms replicated.  ``encode``, ``forward`` and ``prefill`` take the global
batch and keep the rank's "data" block of the tokens and of the frames.
The encoder's output is replicated over "model"; each rank's
cross-attention takes its queries through its ``wq`` columns and its K/V
heads from the encoder's output through its ``wk`` / ``wv`` columns, and
its ``wo`` rows' partial sums are summed over "model".  The caches hold
the rank's batch block and K/V heads, ``cross`` too, as the dense
family's do.  The reference's ``cache_shardings`` splits the caches'
sequence over "model" instead: that is the layout XLA's partitioner is
asked for, and it changes no value; a rank holds 1 / M of the caches'
bytes either way.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.shardctx import ShardCtx, use_shard_ctx
from repro_torch.models.transformer import _DTYPES, LanguageModel, unstack

#: the two stacks: (path, the config's layer count field, attention
#: blocks, norms)
_STACKS = (("enc_blocks", "n_enc_layers", ("attn",), ("ln1", "ln2")),
           ("dec_blocks", "n_layers", ("self_attn", "cross_attn"),
            ("ln1", "ln2", "ln3")))


class _Blocks(nn.Module):
    """One stack of layers: attention blocks named ``attns``, the
    ``ffn`` and the norms ``norms``, each leaf with a leading (n, ...)
    axis; ``shapes``: each leaf's shape (this rank's shard under a
    mesh) by its path in the stack."""

    def __init__(self, device, attns, norms, shapes: dict):
        super().__init__()

        def par(shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=device))

        self.attns, self.norms = tuple(attns), tuple(norms)
        for name in self.attns + ("ffn",):
            setattr(self, name, nn.ParameterDict(
                {k[len(name) + 1:]: par(s) for k, s in shapes.items()
                 if k.startswith(name + "/")}))
        for k in self.norms:
            setattr(self, k, par(shapes[k]))

    def tree(self) -> dict:
        out = {k: dict(getattr(self, k)) for k in self.attns + ("ffn",)}
        out.update({k: getattr(self, k) for k in self.norms})
        return out


class EncDecTransformer(LanguageModel):
    """The encoder-decoder LM; the model API of :class:`LanguageModel`,
    its float input the frames."""

    family = "encdec"
    float_inputs = ("frames",)

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device="cuda", ctx: Optional[ShardCtx] = None):
        super().__init__()
        if (cfg.family != self.family or cfg.n_enc_layers < 1
                or cfg.frontend or not cfg.tie_embeddings):
            raise NotImplementedError(
                f"{cfg.name}: EncDecTransformer builds the 'encdec' family "
                f"with an encoder and tied embeddings (its frames are the "
                f"audio stub)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run = run
        self.dtype = _DTYPES[cfg.dtype]
        self.q_chunk = run.q_chunk if run else 2048
        self.kv_chunk = run.kv_chunk if run else 1024
        self.ctx = ctx
        if ctx is not None:
            self._check_divides(ctx, {"heads": cfg.n_heads,
                                      "d_ff": cfg.d_ff,
                                      "padded vocab": cfg.padded_vocab})
            L.kv_heads_local(cfg, ctx)
        #: each leaf's full (stacked) shape, by path
        self.full_shapes = {"embed": (cfg.padded_vocab, cfg.d_model),
                            "enc_norm": (cfg.d_model,),
                            "final_norm": (cfg.d_model,)}
        for stack, count, attns, norms in _STACKS:
            n = getattr(cfg, count)
            for a in attns:
                self.full_shapes.update({f"{stack}/{a}/{k}": s for k, s in
                                         L.attn_shapes(cfg, n).items()})
            self.full_shapes.update({f"{stack}/ffn/{k}": s for k, s in
                                     L.mlp_shapes(cfg, n).items()})
            self.full_shapes.update({f"{stack}/{k}": (n, cfg.d_model)
                                     for k in norms})
        self._mesh_layout()
        for stack, _, attns, norms in _STACKS:
            shapes = {p[len(stack) + 1:]: self._local_shape(p)
                      for p in self.full_shapes if p.startswith(stack + "/")}
            setattr(self, stack, _Blocks(self.device, attns, norms, shapes))

        def vec(path):
            return nn.Parameter(torch.zeros(self._local_shape(path),
                                            dtype=torch.float32,
                                            device=self.device))

        self.embed = vec("embed")
        self.enc_norm = vec("enc_norm")
        self.final_norm = vec("final_norm")

    def param_shardings(self) -> dict:
        """Each leaf's spec, by path: the reference's — both stacks'
        attention and FFN leaves ``attn_shardings`` / ``mlp_shardings``
        behind a leading None, their norms replicated, the embedding
        vocab-parallel over "model" (``P("model", None)``)."""
        cfg = self.cfg
        out = {"embed": (("model", cfg.padded_vocab), None),
               "enc_norm": (None,), "final_norm": (None,)}
        for stack, _, attns, norms in _STACKS:
            for part, sp in ([(a, L.attn_shardings(cfg)) for a in attns]
                             + [("ffn", L.mlp_shardings(cfg))]):
                out.update({f"{stack}/{part}/{k}": (None,) + v
                            for k, v in sp.items()})
            out.update({f"{stack}/{k}": (None, None) for k in norms})
        return out

    # ---------------- params ----------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random init with the reference's distributions (its RNG stream
        differs): every weight N(0, 1) / sqrt(shape[-2]) (the norms
        zeros), each stacked leaf drawn slice by slice, the encoder's
        first; under a mesh every slice drawn whole and this rank's shard
        kept, so the shards are the unsharded model's of the same
        generator."""
        for stack, _, _, _ in _STACKS:
            blocks = getattr(self, stack)
            for name in blocks.attns + ("ffn",):
                for k, p in getattr(blocks, name).items():
                    path = f"{stack}/{name}/{k}"
                    if k.startswith("w"):
                        self._draw_leaf(path, p, generator,
                                        self.full_shapes[path][-2] ** -0.5)
                    else:
                        p.zero_()
            for k in blocks.norms:
                getattr(blocks, k).zero_()
        self.embed.copy_(L.init_normal(
            generator, self.full_shapes["embed"], 0.02,
            self.device)[self.shard_index("embed")])
        self.enc_norm.zero_()
        self.final_norm.zero_()

    def param_tree(self) -> dict:
        return {"dec_blocks": self.dec_blocks.tree(), "embed": self.embed,
                "enc_blocks": self.enc_blocks.tree(),
                "enc_norm": self.enc_norm, "final_norm": self.final_norm}

    # ---------------- inputs and caches ----------------
    def frames_len(self, S: int) -> int:
        """The frames the stub gives ``S`` tokens."""
        return max(64, S // self.cfg.audio_downsample)

    def frontend_shapes(self, B: int, S: int) -> dict:
        return {"frames": (B, self.frames_len(S), self.cfg.d_model)}

    def init_cache(self, B: int, S: int, F: Optional[int] = None) -> dict:
        """Zeroed caches for ``B`` sequences, in the compute dtype:
        ``self`` ring KV caches of ``S`` positions and ``cross`` K/V of
        ``F`` frames (default :meth:`frames_len` of S), each (n_layers,
        B, S | F, KV, Dh) — under a mesh, this rank's batch block and K/V
        heads."""
        cfg = self.cfg
        F = F or self.frames_len(S)
        shape = (cfg.n_layers, self._cache_batch(B), None,
                 L.kv_heads_local(cfg, self.ctx), cfg.head_dim)

        def kv(n):
            return {k: torch.zeros(shape[:2] + (n,) + shape[3:],
                                   dtype=self.dtype, device=self.device)
                    for k in ("k", "v")}
        return {"self": kv(S), "cross": kv(F)}

    # ---------------- compute ----------------
    def _remat(self) -> bool:
        return (self.run is not None and self.run.remat != "none"
                and torch.is_grad_enabled())

    def _stack(self, stack: str, layer, x, *args):
        """``layer(names, fsdp, x, *args, *weights)`` over ``stack``'s
        layers in turn, each under the model's context (a remat layer's
        recompute runs in the backward, where none is installed; under a
        mesh every rank recomputes each layer whole, its collectives
        included, in the same order)."""
        names, per_layer = unstack(getattr(self, stack).tree())
        fsdp = self._fsdp_dims(stack + "/", names)
        remat = self._remat()
        for i, w in enumerate(per_layer):
            fn = partial(self._in_ctx, layer, names, fsdp, i)
            if remat:
                with set_checkpoint_early_stop(self.ctx is None):
                    x = checkpoint(fn, x, *args, *w, use_reentrant=False)
            else:
                x = fn(x, *args, *w)
        return x

    def _enc_layer(self, names, fsdp, i, x, positions, *w):
        cfg = self.cfg
        p = self._layer_tree(names, fsdp, w)
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
        x = x + L.attn_apply(p["attn"], h, cfg, positions=positions,
                             causal=False, q_chunk=self.q_chunk,
                             kv_chunk=self.kv_chunk)
        h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
        return x + L.mlp_apply(p["ffn"], h)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, D) -> the encoder's output (B, F, D) in the
        compute dtype; under a mesh, of this rank's batch block (its
        whole width on every "model" rank)."""
        with use_shard_ctx(self.ctx):
            x = self._local_batch(frames).to(self.dtype)
            B, F_, _ = x.shape
            positions = torch.arange(F_, device=x.device)[None].expand(B, F_)
            x = self._stack("enc_blocks", self._enc_layer, x, positions)
            return L.rms_norm(x, self.enc_norm, self.cfg.rms_eps)

    def _dec_layer(self, names, fsdp, i, x, positions, mem, caches,
                   cache_len, *w):
        """Decoder layer ``i``; ``mem`` the encoder's output (train /
        prefill: cross-attention over it, prefill writing the layer's
        cross K/V into ``caches``), or None (decode: over the cross K/V
        cache)."""
        cfg = self.cfg
        p = self._layer_tree(names, fsdp, w)
        cache = None
        if caches is not None:
            cache = {part: {kv: c[i] for kv, c in caches[part].items()}
                     for part in ("self", "cross")}
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
        x = x + L.attn_apply(
            p["self_attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["self"],
            cache_len=cache_len, q_chunk=self.q_chunk,
            kv_chunk=self.kv_chunk)
        h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
        if mem is None:
            h = L.cross_attn_decode(p["cross_attn"], h, cache["cross"], cfg)
        else:
            h = L.cross_attn_apply(
                p["cross_attn"], h, mem, cfg,
                cache=None if cache is None else cache["cross"],
                q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)
        x = x + h
        h = L.rms_norm(x, p["ln3"], cfg.rms_eps)
        return x + L.mlp_apply(p["ffn"], h)

    def _backbone(self, x, positions, caches=None, cache_len=None,
                  mem=None):
        """The decoder's layers, then the final norm; ``caches`` (from
        :meth:`init_cache`) written in place."""
        x = self._stack("dec_blocks", self._dec_layer, x, positions, mem,
                        caches, cache_len)
        return L.rms_norm(x, self.final_norm, self.cfg.rms_eps)

    def forward(self, tokens: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) and frames (B, F, D) -> the decoder's final
        hidden states (B, S, D) in the compute dtype (under a mesh, of
        this rank's batch block)."""
        mem = self.encode(frames)
        with use_shard_ctx(self.ctx):
            x = L.embed_lookup(self.embed, self._local_batch(tokens),
                               self.cfg, self.dtype)
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            return self._backbone(x, positions, mem=mem)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                frames: Optional[torch.Tensor] = None):
        """tokens (B, S) and frames (B, F, D) -> (the last position's
        logits (B, 1, V), the caches: ``self`` of ``cache_len`` (default
        S) positions holding the prompt, ``cross`` the F frames' K/V);
        under a mesh, this rank's batch block, the logits its vocabulary
        part."""
        if frames is None:
            raise ValueError(f"{self.cfg.name}: prefill needs the frames")
        mem = self.encode(frames)
        with use_shard_ctx(self.ctx):
            x = L.embed_lookup(self.embed, self._local_batch(tokens),
                               self.cfg, self.dtype)
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            caches = self.init_cache(tokens.shape[0], cache_len or S,
                                     mem.shape[1])
            x = self._backbone(x, positions, caches=caches, mem=mem)
            return self.logits(x[:, -1:]), caches
