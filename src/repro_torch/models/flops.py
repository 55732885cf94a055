"""Analytic MODEL_FLOPS per (arch, shape) — the port's copy of
``repro/models/flops.py``, the "useful compute" yardstick:
6*N*D for training (N = params, active params for MoE; D = tokens),
2*N*D for inference (forward only).  Attention's quadratic term is not
included.  :func:`executed_flops` counts what the MoE's capacity
arithmetic runs instead: every expert over all its C rows.
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
    """FLOPs of one forward (prefill or decode) as the capacity dispatch
    executes it: 2 * N_dense per token for what is not an expert, and
    2 * 3 * D * Fe * E * C per layer in the experts, C the capacity of
    the step's tokens, whatever the router sent.  Equal to
    :func:`model_flops` for a dense model."""
    if shape.kind == "train":
        raise ValueError("executed_flops counts one forward, not a step")
    if cfg.family != "moe":
        return model_flops(cfg, shape)
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                   else 1)
    expert = 3 * cfg.d_model * cfg.d_ff
    dense = (cfg.active_param_count()
             - cfg.n_layers * cfg.experts_per_token * expert)
    return (2.0 * dense * tokens + 2.0 * expert * cfg.n_experts
            * capacity(tokens, cfg) * cfg.n_layers)
