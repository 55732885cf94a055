"""Analytic MODEL_FLOPS per (arch, shape) — the port's copy of
``repro/models/flops.py``, the "useful compute" yardstick:
6*N*D for training (N = params, active params for MoE; D = tokens),
2*N*D for inference (forward only).  Attention's quadratic term is not
included.  :func:`executed_flops` counts what the MoE's capacity
arithmetic runs instead: every expert over all its C rows, in a forward
and (3x) in a train step.  The MFU of a train step is
:func:`model_flops` over its seconds against the card's bf16 dense peak
(989 TFLOP/s on an H100 SXM).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.moe import capacity


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
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
