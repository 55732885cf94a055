"""Griffin-style hybrid LM (recurrentgemma-2b) — port of
``repro/models/rglru.py``: RG-LRU recurrent blocks and local
sliding-window attention in a repeating (rec, rec, attn) pattern.

RG-LRU recurrence (per channel):
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a u_t + b_a))
    i_t = sigmoid(W_i u_t + b_i)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
run by mamba's chunked linear recurrence
(:func:`repro_torch.models.mamba.chunked_linear_recurrence`); the carried
state is (B, D_rnn).  The attention slot is ``layers.attn_apply`` with the
config's sliding window: its ring caches hold ``min(S, window)``
positions.

Under a ("data", "model") mesh (``ctx``) each Parameter holds this
rank's shard of the reference's ``_rec_shardings`` (:func:`rec_shardings`;
the attention and MLP slots take ``layers.attn_shardings`` /
``mlp_shardings``): D_rnn split over "model" — ``w_x`` / ``w_y``'s
columns, the conv, the gates' columns and biases, ``lam``, ``w_out``'s
rows — and ``w_x`` / ``w_y`` / ``w_out`` FSDP over "data".  The gates'
square ``w_a`` / ``w_i`` are column-parallel on an input split over
D_rnn, so :func:`rec_mix` gathers the conv's output over "model" for
them (its gradient reduce-scattered back); the scan and everything else
per channel runs on the rank's channels, and ``w_out``'s partial sums
are summed over "model".  The attention slot's single K/V head, and its
query heads where "model" does not divide them, are split by columns as
the reference splits them and gathered whole at use
(``layers.attn_apply``).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba import (SCAN_CHUNK, RecurrentLM,
                                      causal_depthwise_conv,
                                      chunked_linear_recurrence, gelu_tanh,
                                      sigmoid, silu, softplus)
from repro_torch.models.shardctx import (ShardCtx, copy_to_model,
                                        current_ctx, gather_model_cols,
                                        reduce_model)
from repro_torch.models.transformer import unstack

RGLRU_C = 8.0
GROUP_KINDS = ("rec", "rec", "attn")


def rglru_scan(u, a, h0, *, chunk: int = SCAN_CHUNK):
    """u, a: (B, S, Dr) input and decay; h0: (B, Dr).  Returns (y (B, S,
    Dr), hT (B, Dr)), f32."""
    def inputs(c0, c1):
        return (a[:, c0:c1].float(),
                u[:, c0:c1].to(torch.float32, copy=True))

    return chunked_linear_recurrence(h0, u.shape[1], inputs,
                                     lambda c0, c1, hs: hs, chunk)


def rec_shapes(cfg) -> dict:
    """One RG-LRU mixer's parameter shapes (without the layer axis)."""
    D, Dr, W = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    return {"w_x": (D, Dr), "w_y": (D, Dr), "conv_w": (W, Dr),
            "conv_b": (Dr,), "w_a": (Dr, Dr), "b_a": (Dr,), "w_i": (Dr, Dr),
            "b_i": (Dr,), "lam": (Dr,), "w_out": (Dr, D)}


def rec_shardings() -> dict:
    """One RG-LRU mixer's specs: the reference's ``_rec_shardings``
    (D_rnn over "model", ``w_x`` / ``w_y`` / ``w_out`` FSDP over "data"
    on d_model)."""
    return {"w_x": ("data", "model"), "w_y": ("data", "model"),
            "conv_w": (None, "model"), "conv_b": ("model",),
            "w_a": (None, "model"), "b_a": ("model",),
            "w_i": (None, "model"), "b_i": ("model",), "lam": ("model",),
            "w_out": ("model", "data")}


def rec_mix(p, x, cfg, cache=None):
    """RG-LRU temporal mixer.  x: (B, S, D) -> (B, S, D); ``p`` holds one
    layer's weights.  ``cache``: {"conv": (B, W-1, Dr) in the compute
    dtype, "h": (B, Dr) f32} or None; written in place.  Under a mesh
    (the installed context) ``p`` holds this rank's shards, Dr its
    channels (the module doc)."""
    B, S, _ = x.shape
    dt = x.dtype
    ctx = current_ctx()
    x = copy_to_model(x, ctx)
    u = x @ p["w_x"].to(dt)
    gate = x @ p["w_y"].to(dt)
    u, new_conv = causal_depthwise_conv(
        u, p["conv_w"].to(dt), p["conv_b"],
        cache["conv"] if cache is not None else None)
    # the gates' products need every channel of u (column-parallel)
    u_all = gather_model_cols(u, -1, ctx)
    # r and i * u are read as f32, unrounded (models/mamba.py)
    r = sigmoid(u_all @ p["w_a"].to(dt) + p["b_a"].to(dt), f32=True)
    i = sigmoid(u_all @ p["w_i"].to(dt) + p["b_i"].to(dt), f32=True).to(dt)
    log_a = -RGLRU_C * softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = (torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
                * (i.float() * u.float()))
    h0 = (cache["h"] if cache is not None
          else x.new_zeros((B, u.shape[-1]), dtype=torch.float32))
    y, hT = rglru_scan(gated_in, a, h0)
    y = y.to(dt) * gelu_tanh(gate)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(hT)
    return reduce_model(y @ p["w_out"].to(dt), ctx)


def _depth(cfg) -> tuple:
    """(the (rec, rec, attn) groups, the leftover rec layers)."""
    n = cfg.n_layers // len(GROUP_KINDS)
    return n, cfg.n_layers - len(GROUP_KINDS) * n


def _block_kinds(n_groups: int, tail: int) -> list:
    """(prefix, kind, stacked layers) of every block slot: the groups'
    slots, then the tail's rec slots (a leading axis of 1)."""
    return ([(f"blocks/slot{i}/", kind, n_groups)
             for i, kind in enumerate(GROUP_KINDS)]
            + [(f"tail/slot{i}/", "rec", 1) for i in range(tail)])


def _block_leaf_shapes(cfg, kind: str, n: int) -> dict:
    """One stacked block slot's leaves, by path in the slot."""
    out = {f"mix/{k}": v for k, v in (
        {k: (n,) + s for k, s in rec_shapes(cfg).items()} if kind == "rec"
        else L.attn_shapes(cfg, n)).items()}
    out.update({f"ffn/{k}": v for k, v in L.mlp_shapes(cfg, n).items()})
    out.update({"ln1": (n, cfg.d_model), "ln2": (n, cfg.d_model)})
    return out


class _Block(nn.Module):
    """One stacked block slot, (n, ...) leaves: the pre-norms ``ln1`` /
    ``ln2``, the SwiGLU ``ffn`` and the ``mix``er (RG-LRU or attention),
    each of the shape ``local`` gives it by path in the slot."""

    def __init__(self, kind: str, local: dict, device):
        super().__init__()
        self.kind = kind

        def part(pre):
            return nn.ParameterDict({
                k[len(pre):]: nn.Parameter(torch.zeros(
                    s, dtype=torch.float32, device=device))
                for k, s in local.items() if k.startswith(pre)})

        self.mix = part("mix/")
        self.ffn = part("ffn/")
        self.ln1 = nn.Parameter(torch.zeros(local["ln1"], device=device))
        self.ln2 = nn.Parameter(torch.zeros(local["ln2"], device=device))

    def tree(self) -> dict:
        return {"ffn": dict(self.ffn), "ln1": self.ln1, "ln2": self.ln2,
                "mix": dict(self.mix)}


class GriffinLM(RecurrentLM):
    """recurrentgemma-style hybrid: n_layers // 3 groups of (rec, rec,
    local attn) slots, each stacked on (n_groups, ...) under
    ``blocks/slot{i}``, then the leftover rec layers unrolled under
    ``tail/slot{i}`` with a leading axis of 1 (their caches are
    ``tail{i}``)."""

    family = "hybrid"

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device="cuda", ctx: Optional[ShardCtx] = None):
        super().__init__(cfg, run, device, ctx)
        self.n_groups, self.tail_rec = _depth(cfg)
        self.q_chunk = run.q_chunk if run else 2048
        self.kv_chunk = run.kv_chunk if run else 1024
        blocks = {pre: _Block(kind, {
            k: self._local_shape(pre + k)
            for k in _block_leaf_shapes(cfg, kind, n)}, self.device)
            for pre, kind, n in _block_kinds(self.n_groups, self.tail_rec)}
        self.blocks = nn.ModuleDict({pre.split("/")[1]: b for pre, b in
                                     blocks.items()
                                     if pre.startswith("blocks/")})
        self.tail = nn.ModuleDict({pre.split("/")[1]: b for pre, b in
                                   blocks.items() if pre.startswith("tail/")})

    def _check_mesh(self, ctx: ShardCtx) -> None:
        """The mesh splits the heads' H * Dh columns (parts of heads
        where it does not divide the heads: recurrentgemma-2b's 10 over
        model = 4 or 16), d_ff, D_rnn and the vocabulary evenly over
        "model", and the K/V heads over it or it over them: anything else
        raises (no fall back)."""
        cfg = self.cfg
        self._check_divides(ctx, {"heads x head_dim":
                                  cfg.n_heads * cfg.head_dim,
                                  "d_ff": cfg.d_ff,
                                  "lru_width": cfg.lru_width,
                                  "padded vocab": cfg.padded_vocab})
        L.kv_heads_local(cfg, ctx)

    def _block_shapes(self) -> dict:
        return {pre + k: v
                for pre, kind, n in _block_kinds(*_depth(self.cfg))
                for k, v in _block_leaf_shapes(self.cfg, kind, n).items()}

    def _layers_shardings(self) -> dict:
        cfg, out = self.cfg, {}
        for pre, kind, _ in _block_kinds(*_depth(cfg)):
            mix = rec_shardings() if kind == "rec" else L.attn_shardings(cfg)
            out.update(self._layer_specs(pre + "mix/", mix))
            out.update(self._layer_specs(pre + "ffn/", L.mlp_shardings(cfg)))
            out.update(self._layer_specs(pre, {"ln1": (None,),
                                               "ln2": (None,)}))
        return out

    def _slots(self):
        """(prefix, block) of every slot, the groups' then the tail's."""
        return ([(f"blocks/{k}/", b) for k, b in self.blocks.items()]
                + [(f"tail/{k}/", b) for k, b in self.tail.items()])

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The reference's distributions: RG-LRU ``lam`` linspace(0.1,
        1.5), the biases, ``conv_b`` and the norms zeros, every other
        RG-LRU leaf N(0, 1) / sqrt(shape[0]) of its per-layer shape; the
        attention and FFN weights as in the dense model (1 / sqrt of the
        input width).  Under a mesh each slice is drawn whole and this
        rank's shard kept."""
        for pre, blk in self._slots():
            for k, p in blk.mix.items():
                path = pre + "mix/" + k
                full = self.full_shapes[path]
                if blk.kind == "attn":
                    self._draw_leaf(path, p, generator, full[-2] ** -0.5)
                elif k == "lam":
                    p.copy_(torch.linspace(
                        0.1, 1.5, full[-1], dtype=torch.float32,
                        device=p.device)[self.shard_index(path)[-1]]
                        .expand(p.shape))
                elif k.startswith("b_") or k == "conv_b":
                    p.zero_()
                else:
                    self._draw_leaf(path, p, generator, full[1] ** -0.5)
            for k, p in blk.ffn.items():
                path = pre + "ffn/" + k
                self._draw_leaf(path, p, generator,
                                self.full_shapes[path][-2] ** -0.5)
            blk.ln1.zero_()
            blk.ln2.zero_()
        self._init_shared(generator)

    def param_tree(self) -> dict:
        return {"blocks": {k: b.tree() for k, b in self.blocks.items()},
                "embed": self.embed, "final_norm": self.final_norm,
                "tail": {k: b.tree() for k, b in self.tail.items()}}

    def _rec_cache(self, B: int, n: int) -> dict:
        cfg = self.cfg
        Dr = self.blocks["slot0"].mix["conv_b"].shape[-1]
        return {"conv": torch.zeros((n, B, cfg.conv1d_width - 1, Dr),
                                    dtype=self.dtype, device=self.device),
                "h": torch.zeros((n, B, Dr), dtype=torch.float32,
                                 device=self.device)}

    def init_cache(self, B: int, S: int) -> dict:
        """Zeroed caches for ``B`` sequences of up to ``S`` positions: per
        rec slot the conv carry (compute dtype) and the state (f32), per
        attention slot ring KV caches of ``min(S, window)`` positions;
        ``tail{i}`` for the tail's rec layers (under a mesh: this rank's
        batch block, channels and K/V heads)."""
        cfg = self.cfg
        W = min(S, cfg.sliding_window or S)
        B = self._cache_batch(B)
        KV = L.kv_heads_local(cfg, self.ctx)
        out = {}
        for i, kind in enumerate(GROUP_KINDS):
            out[f"slot{i}"] = (self._rec_cache(B, self.n_groups)
                               if kind == "rec" else
                               {kv: torch.zeros(
                                   (self.n_groups, B, W, KV, cfg.head_dim),
                                   dtype=self.dtype, device=self.device)
                                for kv in ("k", "v")})
        for i in range(self.tail_rec):
            out[f"tail{i}"] = self._rec_cache(B, 1)
        return out

    def _layer(self, kind, names, fsdp, cache, cache_len, x, positions, *w):
        """One block; returns its output in f32, unrounded.  Inside one
        jitted step the reference's norms read a residual sum as f32
        without its bf16 rounding (XLA elides the round trip of the
        norm's ``astype(f32)``, as for the activations of
        ``models/mamba.py``), while the residual stream itself is
        rounded: so each norm here reads the f32 sum, each residual add
        the rounded one, and the caller rounds where the reference's
        layer scan carries the stream (after each group)."""
        cfg, dt = self.cfg, self.dtype
        p = self._layer_tree(names, fsdp, w)
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps).to(dt)
        if kind == "rec":
            h = rec_mix(p["mix"], h, cfg, cache)
        else:
            h = L.attn_apply(p["mix"], h, cfg, positions=positions,
                             window=cfg.sliding_window, cache=cache,
                             cache_len=cache_len, q_chunk=self.q_chunk,
                             kv_chunk=self.kv_chunk)
        x = x.to(dt).float() + h.float()
        h = L.mlp_apply(p["ffn"], L.rms_norm(x, p["ln2"], cfg.rms_eps)
                        .to(dt), act=silu)
        return x.to(dt).float() + h.float()

    def _backbone(self, x, positions, caches=None, cache_len=None):
        """The groups (each slot in order), then the tail, then the final
        norm; ``caches`` written in place."""
        remat = self._remat()

        def run(pre, kind, names, w, cache, x):
            layer = partial(self._layer, kind, names,
                            self._fsdp_dims(pre, names), cache, cache_len)
            return self._call(layer, remat, x, positions, *w)

        slots = [unstack(self.blocks[f"slot{i}"].tree())
                 for i in range(len(GROUP_KINDS))]
        for g in range(self.n_groups):
            for i, (kind, (names, per_layer)) in enumerate(
                    zip(GROUP_KINDS, slots)):
                cache = (None if caches is None else
                         {k: c[g] for k, c in caches[f"slot{i}"].items()})
                x = run(f"blocks/slot{i}/", kind, names, per_layer[g], cache,
                        x)
            x = x.to(self.dtype)
        for i in range(self.tail_rec):
            names, per_layer = unstack(self.tail[f"slot{i}"].tree())
            cache = (None if caches is None else
                     {k: c[0] for k, c in caches[f"tail{i}"].items()})
            x = run(f"tail/slot{i}/", "rec", names, per_layer[0], cache, x)
        x = L.rms_norm(x, self.final_norm, self.cfg.rms_eps)
        return x.to(self.dtype)
