"""Decoder-only dense transformer LM — port of the dense path of
``repro/models/transformer.py`` as an ``nn.Module``.

The parameters keep the reference's tree and stacked layout: one slot
whose weights carry a leading ``(n_layers, ...)`` axis, plus the embedding
and the final norm, so the sorted-key leaf order (and hence the sync
groups and plans) match the reference.  Compute is bf16 on f32 master
weights; each layer is recomputed in the backward pass when the run asks
for remat ("minimal" or "full": ``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class _Slot(nn.Module):
    """One stacked layer slot: attention and MLP weights plus the two
    pre-norms, each with a leading (n_layers, ...) axis."""

    def __init__(self, cfg: ModelConfig, n: int, device):
        super().__init__()

        def par(shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=device))

        self.attn = nn.ParameterDict(
            {k: par(s) for k, s in L.attn_shapes(cfg, n).items()})
        self.ffn = nn.ParameterDict(
            {k: par(s) for k, s in L.mlp_shapes(cfg, n).items()})
        self.ln1 = par((n, cfg.d_model))
        self.ln2 = par((n, cfg.d_model))

    def tree(self) -> dict:
        return {"attn": dict(self.attn), "ffn": dict(self.ffn),
                "ln1": self.ln1, "ln2": self.ln2}


class DenseTransformer(nn.Module):
    """Dense decoder-only LM (the "global" layer pattern)."""

    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device="cuda"):
        super().__init__()
        if (cfg.family != "dense" or cfg.layer_pattern != "global"
                or cfg.qk_norm or cfg.post_norms or cfg.frontend
                or cfg.attn_logit_softcap or cfg.final_logit_softcap
                or cfg.emb_scale_by_dim or not cfg.tie_embeddings):
            raise NotImplementedError(
                f"{cfg.name}: only the plain dense transformer is ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run = run
        self.dtype = _DTYPES[cfg.dtype]
        self.n_groups = cfg.n_layers
        self.blocks = nn.ModuleDict(
            {"slot0": _Slot(cfg, self.n_groups, self.device)})
        self.embed = nn.Parameter(torch.zeros(
            (cfg.padded_vocab, cfg.d_model), dtype=torch.float32,
            device=self.device))
        self.final_norm = nn.Parameter(torch.zeros(
            (cfg.d_model,), dtype=torch.float32, device=self.device))

    # ---------------- params ----------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random init with the reference's distributions (its RNG stream
        differs: parity runs load the reference's weights instead)."""
        slot = self.blocks["slot0"]
        for p in list(slot.attn.values()) + list(slot.ffn.values()):
            p.copy_(L.init_normal(generator, p.shape, p.shape[-2] ** -0.5,
                                  self.device))
        slot.ln1.zero_()
        slot.ln2.zero_()
        self.embed.copy_(L.init_normal(generator, self.embed.shape, 0.02,
                                       self.device))
        self.final_norm.zero_()

    def param_tree(self) -> dict:
        """The parameters as the reference's nested tree (the tensors are
        this module's own Parameters)."""
        return {"blocks": {"slot0": self.blocks["slot0"].tree()},
                "embed": self.embed, "final_norm": self.final_norm}

    def param_shapes(self) -> dict:
        from repro_torch import tree as T
        return T.tree_map(lambda p: tuple(p.shape), self.param_tree())

    # ---------------- forward ----------------
    _ATTN = ("wk", "wo", "wq", "wv")
    _FFN = ("w_down", "w_gate", "w_up")

    def _layer(self, x, positions, *w):
        """One layer; ``w`` are its weights (attention, MLP, the two
        norms) sliced out of the stacks."""
        cfg = self.cfg
        attn = dict(zip(self._ATTN, w[:4]))
        ffn = dict(zip(self._FFN, w[4:7]))
        ln1, ln2 = w[7:]
        h = L.rms_norm(x, ln1, cfg.rms_eps)
        x = x + L.attn_apply(attn, h, cfg, positions=positions)
        h = L.rms_norm(x, ln2, cfg.rms_eps)
        return x + L.mlp_apply(ffn, h)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final hidden states (B, S, D) in bf16."""
        x = L.embed_lookup(self.embed, tokens, self.dtype)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        remat = self.run is not None and self.run.remat != "none"
        p = self.blocks["slot0"]
        # slice the (L, ...) stacks once: the backward of one unbind
        # stacks the per-layer grads in a single pass, where indexing the
        # stack per layer would fill and add a full-stack gradient per
        # layer (quadratic in depth)
        stacks = ([p.attn[k] for k in self._ATTN]
                  + [p.ffn[k] for k in self._FFN] + [p.ln1, p.ln2])
        per_layer = list(zip(*(w.unbind(0) for w in stacks)))
        for w in per_layer:
            if remat and torch.is_grad_enabled():
                x = checkpoint(self._layer, x, positions, *w,
                               use_reentrant=False)
            else:
                x = self._layer(x, positions, *w)
        return L.rms_norm(x, self.final_norm, self.cfg.rms_eps)

    def loss(self, batch: dict) -> torch.Tensor:
        x = self.forward(batch["tokens"])
        return L.xent_loss_chunked(x, self.embed, batch["labels"])
