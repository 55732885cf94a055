"""Building blocks of the transformers — port of
``repro/models/layers.py``: RMSNorm, the logit softcap, RoPE, attention
(training / prefill, causal or — the encoder's — bidirectional, and
single-token decode over a ring KV cache), the encoder-decoder's
cross-attention (prefill writing its K/V cache once, decode reading it),
the ring-cache writes, the SwiGLU MLP, the embedding (with gemma's
sqrt(d) scale) and a chunked cross-entropy through the softcapped LM
head.

Weights are f32 masters cast to the compute dtype (bf16) at use, as the
reference's ``.astype(dt)``; a serving model holds them in bf16 already.
The reference's attention is plain jnp online-softmax attention, not a
Pallas kernel.  Here, where no logit softcap applies, training and
prefill attention is PyTorch's ``scaled_dot_product_attention``;
softcapped layers (gemma2) run :func:`chunked_attention`, the
reference's online softmax, and decode runs :func:`decode_attention`, the
reference's f32 softmax over the ring.  Both packages accept the same
sequence lengths (:func:`check_chunks`).

Under a ("data", "model") mesh (``models/shardctx.py``) each rank holds
the shards that ``attn_shardings`` / ``mlp_shardings`` name (stacked
leaves: one leading None before each spec): attention column-parallel
by whole heads over "model" (wq / wk / wv; wo row-parallel, its partial
sums all-reduced; K/V heads fewer than "model" split by columns as the
reference splits them, each rank gathering its head whole at use), the
MLP likewise (w_gate / w_up columns, w_down
rows), and every weight's d_model dimension over "data" (FSDP, gathered
by the model just before the layer).  The blocks read their head counts
from the weights they are given, so they run the same code on a shard.
:func:`embed_lookup` is vocab-parallel (a masked lookup, summed over
"model") and :func:`lm_logits` leaves the logits vocab-sharded.  The
residual stream is replicated over "model".  In training the blocks'
inputs enter the rank's heads, d_ff columns and vocabulary part through
``copy_to_model`` (its gradient summed over "model"), the row-parallel
sums leave through ``reduce_model``, and :func:`xent_loss_chunked` is
vocab-parallel: the max and the sum of exponentials all-reduced over
"model", the gold logit taken from the rank that owns it (see
``models/shardctx.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.shardctx import (copy_to_model, current_ctx,
                                        gather_model_cols, reduce_model,
                                        use_shard_ctx)

NEG_INF = -1e30


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(dt)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


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


# ---------------------------------------------------------------------------
# attention: training / prefill
# ---------------------------------------------------------------------------


def check_chunks(Sq: int, Sk: int, q_chunk: int, kv_chunk: int):
    """The reference's chunking rule: ``Sq`` a multiple of
    ``min(q_chunk, Sq)`` and ``Sk`` of ``min(kv_chunk, Sk)`` (it asserts;
    this raises ``ValueError``).  Returns the two chunk sizes."""
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    if Sq % qc or Sk % kc:
        raise ValueError(f"attention over {Sq} queries x {Sk} keys does "
                         f"not split into chunks of {qc} x {kc}")
    return qc, kc


def _repeat_kv(k, v, G: int):
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    return k, v


def causal_attention(q, k, v, window: Optional[int] = None):
    """q: (B, S, H, Dh); k, v: (B, S, KV, Dh) with H % KV == 0.  Causal
    SDPA, limited to the last ``window`` positions where one is given.
    Returns (B, S, H, Dh)."""
    k, v = _repeat_kv(k, v, q.shape[2] // k.shape[2])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        pos = torch.arange(q.shape[1], device=q.device)
        d = pos[:, None] - pos[None, :]
        o = F.scaled_dot_product_attention(qt, kt, vt,
                                           attn_mask=(d >= 0) & (d < window))
    return o.transpose(1, 2)


def full_attention(q, k, v):
    """Bidirectional SDPA: q (B, Sq, H, Dh) over k, v (B, Sk, KV, Dh),
    H % KV == 0, every key visible to every query.  Returns (B, Sq, H,
    Dh)."""
    k, v = _repeat_kv(k, v, q.shape[2] // k.shape[2])
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2))
    return o.transpose(1, 2)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      logit_softcap: Optional[float] = None,
                      q_chunk: int = 2048, kv_chunk: int = 1024,
                      q_offset: int = 0):
    """The reference's online-softmax attention; never materialises the
    (Sq, Sk) matrix.  q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh) with
    H % KV == 0.  Returns (B, Sq, H, Dh).  Scores and the running
    max / sum / accumulator are f32; p is rounded to q's dtype before PV.

    A (q, kv) chunk pair whose every entry is masked is skipped: before
    the first visible chunk the reference's accumulator is wiped by a
    correction factor of exactly 0, after the last one a masked chunk
    adds exactly 0, so the result is the same."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q_chunk, kv_chunk = check_chunks(Sq, Sk, q_chunk, kv_chunk)
    scale = 1.0 / math.sqrt(Dh)
    k, v = _repeat_kv(k, v, H // KV)
    dev = q.device
    out = torch.empty_like(q)
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk].float()
        lo, hi = q_offset + q0, q_offset + q0 + q_chunk - 1
        q_pos = torch.arange(lo, hi + 1, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, H, q_chunk), device=dev)
        acc = torch.zeros((B, H, q_chunk, Dh), device=dev)
        for k0 in range(0, Sk, kv_chunk):
            k1 = k0 + kv_chunk - 1
            if (causal and k0 > hi) or (window is not None
                                        and lo - k1 >= window):
                continue
            k_pos = torch.arange(k0, k1 + 1, device=dev)
            s = torch.einsum("bqhd,bshd->bhqs", qc,
                             k[:, k0:k1 + 1].float()) * scale
            s = softcap(s, logit_softcap)
            d = q_pos[:, None] - k_pos[None, :]
            mask = torch.ones_like(d, dtype=torch.bool)
            if causal:
                mask &= d >= 0
            if window is not None:
                mask &= d < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqs,bshd->bhqd", p.to(q.dtype).float(),
                              v[:, k0:k1 + 1].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)
        out[:, q0:q0 + q_chunk] = o.transpose(1, 2)
    return out


# ---------------------------------------------------------------------------
# attention: decode over a ring KV cache
# ---------------------------------------------------------------------------


def ring_slot_positions(t: int, alloc: int, device=None):
    """Absolute position held by each ring-cache slot after the token at
    position ``t`` has been written (slot j holds the latest position
    p <= t with p % alloc == j; negative => never written)."""
    j = torch.arange(alloc, device=device)
    return t - torch.remainder(t - j, alloc)


def decode_attention(q, k_cache, v_cache, t: int, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None):
    """Single-token attention over a ring KV cache.  q: (B, 1, H, Dh);
    k_cache / v_cache: (B, S_alloc, KV, Dh); ``t``: absolute position of
    the current token (already written into the cache).  f32 scores and
    softmax over the ring, with a position and a window mask; p is
    rounded to q's dtype before the f32 PV product."""
    B, _, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, Dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) \
        * (1.0 / math.sqrt(Dh))
    s = softcap(s, logit_softcap)
    pos = ring_slot_positions(t, S, q.device)
    mask = (pos >= 0) & (pos <= t)
    if window is not None:
        mask &= pos > (t - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def ring_write_decode(cache, kv, t: int):
    """Write one token (B, 1, KV, Dh) into a ring cache (B, alloc, KV, Dh)
    at slot t % alloc, in place; returns ``cache``."""
    cache[:, t % cache.shape[1]] = kv[:, 0]
    return cache


def ring_write_prefill(cache, kv):
    """Write a full prefill (B, S, KV, Dh) into a ring cache of alloc W,
    in place; returns ``cache``.  If S <= W this is a plain front write
    (slot j == position j).  Otherwise only the last W positions are kept,
    placed so position p sits in slot p % W (consistent with
    :func:`ring_slot_positions`)."""
    S, W = kv.shape[1], cache.shape[1]
    if S <= W:
        cache[:, :S] = kv
        return cache
    j = torch.arange(W, device=kv.device)
    src = (S - W) + torch.remainder(j - (S - W), W)  # position in slot j
    cache.copy_(kv.index_select(1, src))
    return cache


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


def init_normal(generator: torch.Generator, shape, std: float, device):
    """N(0, std^2) of ``shape`` in f32 on ``device``, drawn from
    ``generator`` (on its own device); scaled in place, so the draw is
    the only f32 temporary of its size."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device).mul_(std)


def attn_shapes(cfg, n_layers: int):
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (n_layers, D, H * Dh), "wk": (n_layers, D, KV * Dh),
              "wv": (n_layers, D, KV * Dh), "wo": (n_layers, H * Dh, D)}
    if cfg.qk_norm:
        shapes["q_norm"] = (n_layers, Dh)
        shapes["k_norm"] = (n_layers, Dh)
    return shapes


def attn_shardings(cfg) -> dict:
    """One layer's attention specs: the reference's ``attn_shardings``
    (column-parallel in, row-parallel out, FSDP over "data" on d_model),
    the "model" splits of wq / wo by whole heads; wk / wv split their
    columns evenly, as the reference does — whole heads where "model"
    divides the K/V heads, else a part of one head, which
    :func:`attn_apply` gathers whole (:func:`kv_heads_local`)."""
    H = cfg.n_heads
    sp = {"wq": ("data", ("model", H)), "wk": ("data", "model"),
          "wv": ("data", "model"), "wo": (("model", H), "data")}
    if cfg.qk_norm:
        sp["q_norm"] = (None,)
        sp["k_norm"] = (None,)
    return sp


def kv_heads_local(cfg, ctx) -> int:
    """The K/V heads a rank of ``ctx``'s mesh attends with (and caches):
    its part of them where "model" divides the K/V heads, else the one
    head its query heads share (the heads must divide "model")."""
    KV = cfg.n_kv_heads
    if ctx is None or KV % ctx.M == 0:
        return KV // (1 if ctx is None else ctx.M)
    if ctx.M % KV:
        raise ValueError(f"{cfg.name}: {KV} K/V heads do not split over "
                         f"model = {ctx.M}, nor model over them")
    return 1


def _kv_weights(p, cfg, ctx):
    """wk / wv of the rank's K/V heads: its own shard where "model"
    divides the heads, else its query heads' one head, gathered from the
    ranks that hold a part of it (its gradient reduce-scattered back to
    the parts)."""
    wk, wv = p["wk"], p["wv"]
    if ctx is None or ctx.M == 1 or cfg.n_kv_heads % ctx.M == 0:
        return wk, wv
    Dh = cfg.head_dim
    u = ctx.m // (ctx.M // cfg.n_kv_heads)
    return tuple(gather_model_cols(w, -1, ctx).narrow(-1, u * Dh, Dh)
                 for w in (wk, wv))


def attn_apply(p, x, cfg, *, positions, causal: bool = True,
               window: Optional[int] = None, cache=None,
               cache_len: Optional[int] = None, q_chunk: int = 2048,
               kv_chunk: int = 1024):
    """x: (B, S, D) -> (B, S, D); ``p`` holds one layer's weights.
    ``causal=False`` is the encoder's bidirectional self-attention (RoPE
    still applied, the same chunk rule).

    ``cache`` is one layer's ``{"k", "v"}`` ring caches (B, alloc, KV, Dh)
    or None.  Decode (``cache_len`` given, S == 1) writes the token at
    slot ``cache_len % alloc`` and attends over the ring; prefill
    (``cache`` without ``cache_len``) attends over the sequence and writes
    its tail into the ring.  The caches are written in place.  Under a
    mesh ``p`` holds this rank's heads (K/V heads fewer than "model":
    parts of one, gathered whole here), and wo's partial sums are summed
    over "model"."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    wk, wv = _kv_weights(p, cfg, current_ctx())
    H, KV = p["wq"].shape[-1] // Dh, wk.shape[-1] // Dh
    dt = x.dtype
    x = copy_to_model(x)
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, Dh)
    k = (x @ wk.to(dt)).reshape(B, S, KV, Dh)
    v = (x @ wv.to(dt)).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    cap = cfg.attn_logit_softcap
    if cache is not None and cache_len is not None and S == 1:
        kc = ring_write_decode(cache["k"], k, cache_len)
        vc = ring_write_decode(cache["v"], v, cache_len)
        o = decode_attention(q, kc.to(dt), vc.to(dt), cache_len,
                             window=window, logit_softcap=cap)
    else:
        if cap is None and (causal or window is None):
            check_chunks(S, S, q_chunk, kv_chunk)
            o = (causal_attention(q, k, v, window) if causal
                 else full_attention(q, k, v))
        else:
            o = chunked_attention(q, k, v, causal=causal, window=window,
                                  logit_softcap=cap, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
        if cache is not None:
            ring_write_prefill(cache["k"], k)
            ring_write_prefill(cache["v"], v)
    return reduce_model(o.reshape(B, S, H * Dh) @ p["wo"].to(dt))


def cross_attn_apply(p, x, mem, cfg, *, cache=None, q_chunk: int = 2048,
                     kv_chunk: int = 1024):
    """Encoder-decoder cross-attention: queries from x (B, S, D), keys
    and values from the encoder's output mem (B, Sm, D); no RoPE, no
    qk-norm, no softcap, every key visible (the reference's
    ``chunked_attention(causal=False)``, its chunk rule kept).  ``cache``
    (one layer's ``{"k", "v"}`` of (B, Sm, KV, Dh)), where given, takes
    the keys and values in place: prefill writes them once."""
    B, S, _ = x.shape
    Sm = mem.shape[1]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, Dh)
    k = (mem @ p["wk"].to(dt)).reshape(B, Sm, KV, Dh)
    v = (mem @ p["wv"].to(dt)).reshape(B, Sm, KV, Dh)
    if cache is not None:
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    check_chunks(S, Sm, q_chunk, kv_chunk)
    o = full_attention(q, k, v)
    return o.reshape(B, S, H * Dh) @ p["wo"].to(dt)


def cross_attn_decode(p, x, cache, cfg):
    """One token's cross-attention (x: (B, 1, D)) over the K/V cache that
    prefill wrote (B, F, KV, Dh): the reference's ``decode_attention`` at
    t = F - 1, under which every slot is visible."""
    B = x.shape[0]
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    F_ = cache["k"].shape[1]
    o = decode_attention(q, cache["k"].to(dt), cache["v"].to(dt), F_ - 1)
    return o.reshape(B, 1, -1) @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_shapes(cfg, n_layers: int):
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_gate": (n_layers, D, Fd), "w_up": (n_layers, D, Fd),
            "w_down": (n_layers, Fd, D)}


def mlp_shardings(cfg) -> dict:
    """One layer's MLP specs: the reference's ``mlp_shardings``, d_ff
    split evenly over "model"."""
    Fd = cfg.d_ff
    return {"w_gate": ("data", ("model", Fd)), "w_up": ("data", ("model", Fd)),
            "w_down": (("model", Fd), "data")}


def mlp_apply(p, x, act=F.silu):
    """SwiGLU MLP; ``p`` holds one layer's weights (under a mesh, this
    rank's d_ff columns: the partial sums are summed over "model");
    ``act`` the gate's activation."""
    dt = x.dtype
    x = copy_to_model(x)
    h = act(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return reduce_model(h @ p["w_down"].to(dt))


# ---------------------------------------------------------------------------
# embedding, LM head and chunked cross-entropy
# ---------------------------------------------------------------------------


def embed_lookup(emb, tokens, cfg, dtype):
    """Rows of ``emb`` in ``dtype``; gemma scales them by sqrt(d_model)
    rounded to ``dtype`` (the reference's ``jnp.asarray(sqrt(d), dtype)``:
    59.75 for d = 3584 in bf16).  Under a mesh ``emb`` is this rank's
    contiguous part of the vocabulary ("model"): the tokens outside it
    look up zeros, and the parts are summed over "model" (one non-zero
    term each: exact)."""
    ctx = current_ctx()
    if ctx is not None and ctx.M > 1:
        v0 = ctx.m * emb.shape[0]
        local = tokens.long() - v0
        mine = (local >= 0) & (local < emb.shape[0])
        x = F.embedding(local.clamp(0, emb.shape[0] - 1), emb).to(dtype)
        x = reduce_model(torch.where(mine[..., None], x, 0.0), ctx)
    else:
        x = F.embedding(tokens.long(), emb).to(dtype)
    if cfg.emb_scale_by_dim:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))
    return x


def lm_logits(x, emb_dt, cfg):
    """Logits in x's dtype against the embedding ``emb_dt`` (already in
    that dtype), then the final softcap in that dtype; under a mesh, this
    rank's vocabulary part of them."""
    return softcap(x @ emb_dt.T, cfg.final_logit_softcap)


def xent_loss_chunked(x, emb, labels, cfg, *, seq_chunk: int = 512):
    """Mean token cross-entropy over sequence chunks (full-vocab logits
    only ever exist for one chunk at a time, in the backward too); the
    logits go through :func:`lm_logits`, final softcap included.  Under a
    mesh ``emb`` is this rank's vocabulary part and the chunks' sums are
    vocab-parallel (:func:`_chunk_nll`)."""
    B, S, _ = x.shape
    seq_chunk = min(seq_chunk, S)
    if S % seq_chunk:
        raise ValueError(f"seq {S} not a multiple of chunk {seq_chunk}")
    emb_dt = emb.to(x.dtype)
    tot = x.new_zeros((), dtype=torch.float32)
    ctx = current_ctx()
    for c0 in range(0, S, seq_chunk):
        args = (x[:, c0:c0 + seq_chunk], emb_dt,
                labels[:, c0:c0 + seq_chunk].long(), cfg, ctx)
        if torch.is_grad_enabled():
            # the chunk's logits are recomputed in the backward, the same
            # arithmetic, rather than kept: only one chunk's full-vocab
            # logits ever exist
            nll = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            nll = _chunk_nll(*args)
        tot = tot + nll
    return tot / float(B * S)


def _chunk_nll(x, emb_dt, labels, cfg, ctx=None):
    """Summed token cross-entropy of one sequence chunk.  Under ``ctx``
    (passed, not read from the installed context: the backward recomputes
    this where none is installed) with M > 1 the rank's logits are its
    vocabulary part: the row max all-reduced over "model" (a constant of
    the softmax: no gradient), then the sum of exponentials and the gold
    logit (each label's owner contributes it, the others 0) summed over
    "model" in one all-reduce."""
    if ctx is None or ctx.M == 1:
        logits = lm_logits(x, emb_dt, cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.sum(lse - gold)
    with use_shard_ctx(ctx):
        logits = lm_logits(copy_to_model(x), emb_dt, cfg).float()
        Vl = emb_dt.shape[0]
        m = ctx.all_reduce_max(logits.detach().amax(dim=-1), "model")
        local = labels - ctx.m * Vl
        mine = (local >= 0) & (local < Vl)
        gold = torch.gather(logits, -1,
                            local.clamp(0, Vl - 1)[..., None])[..., 0]
        sums = reduce_model(torch.stack([
            torch.exp(logits - m[..., None]).sum(dim=-1),
            torch.where(mine, gold, 0.0)]))
        return torch.sum(torch.log(sums[0]) + m - sums[1])
