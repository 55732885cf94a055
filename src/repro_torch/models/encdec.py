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
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_DTYPES, LanguageModel, _draw,
                                            unstack)


class _Blocks(nn.Module):
    """One stack of ``n`` layers: attention blocks named ``attns``, the
    ``ffn`` and the norms ``norms``, each leaf with a leading (n, ...)
    axis."""

    def __init__(self, cfg: ModelConfig, n: int, device, attns, norms):
        super().__init__()

        def par(shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=device))

        self.attns, self.norms = tuple(attns), tuple(norms)
        for name in self.attns:
            setattr(self, name, nn.ParameterDict(
                {k: par(s) for k, s in L.attn_shapes(cfg, n).items()}))
        self.ffn = nn.ParameterDict(
            {k: par(s) for k, s in L.mlp_shapes(cfg, n).items()})
        for k in self.norms:
            setattr(self, k, par((n, cfg.d_model)))

    def tree(self) -> dict:
        out = {k: dict(getattr(self, k)) for k in self.attns + ("ffn",)}
        out.update({k: getattr(self, k) for k in self.norms})
        return out

    def init(self, generator: torch.Generator) -> None:
        """The reference's distributions: every weight N(0, 1) /
        sqrt(shape[-2]) (qk-norm weights and the norms zeros), drawn one
        layer at a time."""
        for name in self.attns + ("ffn",):
            for k, p in getattr(self, name).items():
                if k.startswith("w"):
                    _draw(p, generator, p.shape[-2] ** -0.5)
                else:
                    p.zero_()
        for k in self.norms:
            getattr(self, k).zero_()


class EncDecTransformer(LanguageModel):
    """The encoder-decoder LM; the model API of :class:`LanguageModel`,
    its float input the frames."""

    family = "encdec"
    float_inputs = ("frames",)

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device="cuda"):
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
        self.enc_blocks = _Blocks(cfg, cfg.n_enc_layers, self.device,
                                  ("attn",), ("ln1", "ln2"))
        self.dec_blocks = _Blocks(cfg, cfg.n_layers, self.device,
                                  ("self_attn", "cross_attn"),
                                  ("ln1", "ln2", "ln3"))

        def vec(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=self.device))

        self.embed = vec(cfg.padded_vocab, cfg.d_model)
        self.enc_norm = vec(cfg.d_model)
        self.final_norm = vec(cfg.d_model)

    # ---------------- params ----------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random init with the reference's distributions (its RNG stream
        differs), each stacked leaf drawn slice by slice."""
        self.enc_blocks.init(generator)
        self.dec_blocks.init(generator)
        self.embed.copy_(L.init_normal(generator, self.embed.shape, 0.02,
                                       self.device))
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
        B, S | F, KV, Dh)."""
        cfg = self.cfg
        F = F or self.frames_len(S)

        def kv(n):
            return {k: torch.zeros((cfg.n_layers, B, n, cfg.n_kv_heads,
                                    cfg.head_dim), dtype=self.dtype,
                                   device=self.device) for k in ("k", "v")}
        return {"self": kv(S), "cross": kv(F)}

    # ---------------- compute ----------------
    def _remat(self) -> bool:
        return (self.run is not None and self.run.remat != "none"
                and torch.is_grad_enabled())

    def _enc_layer(self, names, x, positions, *w):
        cfg = self.cfg
        p = T.from_flat_dict(dict(zip(names, w)))
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
        x = x + L.attn_apply(p["attn"], h, cfg, positions=positions,
                             causal=False, q_chunk=self.q_chunk,
                             kv_chunk=self.kv_chunk)
        h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
        return x + L.mlp_apply(p["ffn"], h)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, D) -> the encoder's output (B, F, D) in the
        compute dtype."""
        x = frames.to(self.dtype)
        B, F_, _ = x.shape
        positions = torch.arange(F_, device=x.device)[None].expand(B, F_)
        remat = self._remat()
        names, per_layer = unstack(self.enc_blocks.tree())
        for w in per_layer:
            layer = partial(self._enc_layer, names)
            if remat:
                x = checkpoint(layer, x, positions, *w, use_reentrant=False)
            else:
                x = layer(x, positions, *w)
        return L.rms_norm(x, self.enc_norm, self.cfg.rms_eps)

    def _dec_layer(self, names, cache, cache_len, x, positions, mem, *w):
        """One decoder layer; ``mem`` the encoder's output (train /
        prefill: cross-attention over it, prefill writing ``cache``'s
        cross K/V), or None (decode: over the cross K/V cache)."""
        cfg = self.cfg
        p = T.from_flat_dict(dict(zip(names, w)))
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
        remat = self._remat()
        names, per_layer = unstack(self.dec_blocks.tree())
        for i, w in enumerate(per_layer):
            cache = None
            if caches is not None:
                cache = {part: {kv: c[i] for kv, c in caches[part].items()}
                         for part in ("self", "cross")}
            layer = partial(self._dec_layer, names, cache, cache_len)
            if remat:
                x = checkpoint(layer, x, positions, mem, *w,
                               use_reentrant=False)
            else:
                x = layer(x, positions, mem, *w)
        return L.rms_norm(x, self.final_norm, self.cfg.rms_eps)

    def forward(self, tokens: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) and frames (B, F, D) -> the decoder's final
        hidden states (B, S, D) in the compute dtype."""
        mem = self.encode(frames)
        x = L.embed_lookup(self.embed, tokens, self.cfg, self.dtype)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        return self._backbone(x, positions, mem=mem)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                frames: Optional[torch.Tensor] = None):
        """tokens (B, S) and frames (B, F, D) -> (the last position's
        logits (B, 1, V), the caches: ``self`` of ``cache_len`` (default
        S) positions holding the prompt, ``cross`` the F frames' K/V)."""
        if frames is None:
            raise ValueError(f"{self.cfg.name}: prefill needs the frames")
        mem = self.encode(frames)
        x = L.embed_lookup(self.embed, tokens, self.cfg, self.dtype)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        caches = self.init_cache(B, cache_len or S, mem.shape[1])
        x = self._backbone(x, positions, caches=caches, mem=mem)
        return self.logits(x[:, -1:]), caches
