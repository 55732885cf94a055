"""Analytic MODEL_FLOPS per (arch, shape) — the port's copy of
``repro/models/flops.py``, the "useful compute" yardstick:
6*N*D for training (N = params, active params for MoE; D = tokens),
2*N*D for inference (forward only).  Attention's quadratic term is not
included.  N is the config's (active) count unless the caller, which
holds the model, passes the tree's (``LanguageModel.active_param_count``:
the config's count approximates the hybrid's RG-LRU gates; on a mesh
rank it counts the whole model's leaves, not the rank's shards).
:func:`executed_flops` counts what the MoE's capacity arithmetic runs
instead: every expert over all its C rows, in a forward and (3x) in a
train step; and the encoder-decoder's matmuls as they run, its encoder
over the F frames rather than the S tokens the yardstick counts it
over.  The MFU of a train step is
:func:`model_flops` over its seconds against the card's bf16 dense peak
(989 TFLOP/s on an H100 SXM), on a ("data", "model") mesh against the
D·M cards' (:func:`mfu`).  :func:`decode_step_bytes` is what one
decode step must move, from the split of :func:`cache_bytes`, and
:func:`decode_bound_ms` its least time on one card at the card's memory
rate; on a ("data", "model") mesh each card moves its own weights and
caches, so the bound is per card.  :func:`scan_start_bytes`
is what mamba's ``SelectiveScan`` saves for its backward besides its
inputs.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.mamba import SCAN_CHUNK
from repro_torch.models.moe import capacity

#: the cache entries that are recurrent state (the conv carry and the
#: scan state); every other entry is a ring KV cache
_STATE = ("conv", "h")
#: an H100 SXM's memory rate, bytes per second (the data sheet)
HBM_BYTES_PER_S = 3.35e12
#: an H100 SXM's dense bf16 peak, FLOP/s (the data sheet)
BF16_DENSE_FLOPS = 989e12


def mfu(flops: float, seconds: float, cards: int = 1) -> float:
    """Model FLOPs utilisation: ``flops`` in ``seconds`` over ``cards``
    cards' bf16 dense peak (a D x M mesh: D·M cards)."""
    return flops / seconds / (cards * BF16_DENSE_FLOPS)


def cache_bytes(caches: dict) -> tuple:
    """(recurrent-state bytes, ring KV bytes) of a model's caches."""
    state = ring = 0
    for slot in caches.values():
        for name, t in slot.items():
            b = t.numel() * t.element_size()
            if name in _STATE:
                state += b
            else:
                ring += b
    return state, ring


def decode_step_bytes(weight_bytes: int, caches: dict) -> int:
    """The bytes one decode step must move: every weight read once, each
    ring KV cache read whole, each recurrent state read and written."""
    state, ring = cache_bytes(caches)
    return weight_bytes + 2 * state + ring


def decode_bound_ms(weight_bytes: int, caches: dict) -> float:
    """The least time of one decode step on one card, ms: its
    :func:`decode_step_bytes` (on a mesh rank: that card's weights and
    caches) at ``HBM_BYTES_PER_S``."""
    return decode_step_bytes(weight_bytes, caches) / HBM_BYTES_PER_S * 1e3


def model_flops(cfg: ModelConfig, shape: ShapeConfig,
                n: int | None = None) -> float:
    """The yardstick's FLOPs; ``n`` the model's N (default the config's
    active count)."""
    if n is None:
        n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def executed_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """FLOPs as the capacity dispatch executes them: for one forward
    (prefill or decode), 2 * N_dense per token for what is not an
    expert, and 2 * 3 * D * Fe * E * C per layer in the experts, C the
    capacity of the step's tokens, whatever the router sent; for a train
    step, 3x its forward's (the backward twice the forward, as 6 * N * D
    counts it; a layer recomputed under remat is not counted).  Equal to
    :func:`model_flops` for a dense model."""
    if cfg.family == "encdec":
        return _encdec_flops(cfg, shape)
    if cfg.family != "moe":
        return model_flops(cfg, shape)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    expert = 3 * cfg.d_model * cfg.d_ff
    dense = (cfg.active_param_count()
             - cfg.n_layers * cfg.experts_per_token * expert)
    forward = (2.0 * dense * tokens + 2.0 * expert * cfg.n_experts
               * capacity(tokens, cfg) * cfg.n_layers)
    return 3.0 * forward if shape.kind == "train" else forward


def _encdec_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The encoder-decoder's matmul FLOPs as they run: the encoder's
    layers over the F = max(64, S // audio_downsample) frames, the
    decoder's over the S tokens — but the cross-attention's K / V
    projections, which run over the F frames — and the tied LM head over
    the positions whose logits are taken (every one in training, the
    last in prefill); decode (one token) runs no encoder and reads the
    cross K / V from its cache.  A train step is 3x its forward."""
    D, Fd = cfg.d_model, cfg.d_ff
    q_o = 2 * D * cfg.n_heads * cfg.head_dim
    k_v = 2 * D * cfg.n_kv_heads * cfg.head_dim
    layer = q_o + k_v + 3 * D * Fd
    B, S = shape.global_batch, shape.seq_len
    head = cfg.padded_vocab * D
    if shape.kind == "decode":
        return 2.0 * B * (cfg.n_layers * (layer + q_o) + head)
    frames = max(64, S // cfg.audio_downsample)
    fwd = 2.0 * B * (cfg.n_enc_layers * layer * frames
                     + cfg.n_layers * ((layer + q_o) * S + k_v * frames)
                     + head * (S if shape.kind == "train" else 1))
    return 3.0 * fwd if shape.kind == "train" else fwd


def scan_start_bytes(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Bytes of the chunk-start states one mamba layer's ``SelectiveScan``
    saves for its backward: a (B, D_inner, N) f32 state per chunk of
    ``min(SCAN_CHUNK, S)`` positions (0 for a model without that scan).
    Under remat they exist for one layer at a time."""
    if cfg.family != "ssm":
        return 0
    chunks = shape.seq_len // min(SCAN_CHUNK, shape.seq_len)
    return chunks * shape.global_batch * cfg.d_inner * cfg.ssm_state * 4
