"""Analytic MODEL_FLOPS per (arch, shape) — the port's copy of
``repro/models/flops.py``, the "useful compute" yardstick:
6*N*D for training (N = params, active params for MoE; D = tokens),
2*N*D for inference (forward only).  Attention's quadratic term is not
included.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


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
