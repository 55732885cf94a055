"""Building blocks of the dense transformer — port of the parts of
``repro/models/layers.py`` the dense LM trains with: RMSNorm, RoPE, causal
attention, the SwiGLU MLP, the embedding and a chunked cross-entropy.

Weights are f32 masters cast to the compute dtype (bf16) at use, as the
reference's ``.astype(dt)``.  The reference's attention is plain jnp
online-softmax attention, not a Pallas kernel; here it is PyTorch's
``scaled_dot_product_attention``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(dt)


def rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def causal_attention(q, k, v):
    """q: (B, S, H, Dh); k, v: (B, S, KV, Dh) with H % KV == 0.
    Returns (B, S, H, Dh)."""
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=True)
    return o.transpose(1, 2)


def init_normal(generator: torch.Generator, shape, std: float, device):
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device) * std


def attn_shapes(cfg, n_layers: int):
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (n_layers, D, H * Dh), "wk": (n_layers, D, KV * Dh),
            "wv": (n_layers, D, KV * Dh), "wo": (n_layers, H * Dh, D)}


def attn_apply(p, x, cfg, *, positions):
    """x: (B, S, D) -> (B, S, D); ``p`` holds one layer's weights."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, Dh)
    k = (x @ p["wk"].to(dt)).reshape(B, S, KV, Dh)
    v = (x @ p["wv"].to(dt)).reshape(B, S, KV, Dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = causal_attention(q, k, v)
    return o.reshape(B, S, H * Dh) @ p["wo"].to(dt)


def mlp_shapes(cfg, n_layers: int):
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_gate": (n_layers, D, Fd), "w_up": (n_layers, D, Fd),
            "w_down": (n_layers, Fd, D)}


def mlp_apply(p, x):
    """SwiGLU MLP; ``p`` holds one layer's weights."""
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


def embed_lookup(emb, tokens, dtype):
    return F.embedding(tokens.long(), emb).to(dtype)


def lm_logits(x, emb_dt):
    return x @ emb_dt.T


def xent_loss_chunked(x, emb, labels, *, seq_chunk: int = 512):
    """Mean token cross-entropy over sequence chunks (full-vocab logits
    only ever exist for one chunk at a time)."""
    B, S, _ = x.shape
    seq_chunk = min(seq_chunk, S)
    if S % seq_chunk:
        raise ValueError(f"seq {S} not a multiple of chunk {seq_chunk}")
    emb_dt = emb.to(x.dtype)
    tot = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, seq_chunk):
        logits = lm_logits(x[:, c0:c0 + seq_chunk], emb_dt).float()
        lse = torch.logsumexp(logits, dim=-1)
        lab = labels[:, c0:c0 + seq_chunk].long()
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        tot = tot + torch.sum(lse - gold)
    return tot / float(B * S)
