"""Architecture configs of the port: the paper's own dense model and the
JAX package's whole zoo — the dense transformers (qwen3-8b, gemma2-9b,
minitron-8b, starcoder2-3b, and llava-next-mistral-7b, the dense stack
behind a stub of precomputed patch embeddings), the MoE family
(qwen3-moe-30b-a3b, dbrx-132b), the recurrent families (falcon-mamba-7b,
the selective-scan SSM; recurrentgemma-2b, the RG-LRU + local-attention
hybrid) and the encoder-decoder seamless-m4t-medium (a stub of
precomputed audio frame embeddings into its encoder) — each with its
reduced *smoke* variant for CPU tests."""
from __future__ import annotations

from repro_torch.configs.base import (ACESyncConfig, ModelConfig, RunConfig,
                                      SHAPES, ShapeConfig)
from repro_torch.configs.dbrx_132b import CONFIG as dbrx_132b
from repro_torch.configs.dbrx_132b import SMOKE as dbrx_132b_smoke
from repro_torch.configs.falcon_mamba_7b import CONFIG as falcon_mamba_7b
from repro_torch.configs.falcon_mamba_7b import SMOKE as falcon_mamba_7b_smoke
from repro_torch.configs.gemma2_9b import CONFIG as gemma2_9b
from repro_torch.configs.gemma2_9b import SMOKE as gemma2_9b_smoke
from repro_torch.configs.llava_next_mistral_7b import \
    CONFIG as llava_next_mistral_7b
from repro_torch.configs.llava_next_mistral_7b import \
    SMOKE as llava_next_mistral_7b_smoke
from repro_torch.configs.minitron_8b import CONFIG as minitron_8b
from repro_torch.configs.minitron_8b import SMOKE as minitron_8b_smoke
from repro_torch.configs.paper_350m import CONFIG as paper_350m
from repro_torch.configs.paper_350m import SMOKE as paper_350m_smoke
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b
from repro_torch.configs.qwen3_8b import SMOKE as qwen3_8b_smoke
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from repro_torch.configs.qwen3_moe_30b_a3b import \
    SMOKE as qwen3_moe_30b_a3b_smoke
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.recurrentgemma_2b import \
    SMOKE as recurrentgemma_2b_smoke
from repro_torch.configs.seamless_m4t_medium import \
    CONFIG as seamless_m4t_medium
from repro_torch.configs.seamless_m4t_medium import \
    SMOKE as seamless_m4t_medium_smoke
from repro_torch.configs.starcoder2_3b import CONFIG as starcoder2_3b
from repro_torch.configs.starcoder2_3b import SMOKE as starcoder2_3b_smoke

ARCHS = {
    "dbrx-132b": dbrx_132b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "minitron-8b": minitron_8b,
    "qwen3-8b": qwen3_8b,
    "starcoder2-3b": starcoder2_3b,
    "gemma2-9b": gemma2_9b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "paper-350m": paper_350m,
}
SMOKE_ARCHS = {
    "dbrx-132b": dbrx_132b_smoke,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b_smoke,
    "minitron-8b": minitron_8b_smoke,
    "qwen3-8b": qwen3_8b_smoke,
    "starcoder2-3b": starcoder2_3b_smoke,
    "gemma2-9b": gemma2_9b_smoke,
    "falcon-mamba-7b": falcon_mamba_7b_smoke,
    "llava-next-mistral-7b": llava_next_mistral_7b_smoke,
    "recurrentgemma-2b": recurrentgemma_2b_smoke,
    "seamless-m4t-medium": seamless_m4t_medium_smoke,
    "paper-350m": paper_350m_smoke,
}

#: archs whose long_500k cell is kept: the recurrent ones (the
#: full-attention archs skip it, as the reference's dry run does)
LONG_CONTEXT_ARCHS = {"falcon-mamba-7b", "recurrentgemma-2b"}


def cells(include_long_skips: bool = False):
    """Every (arch, shape) cell of the dry run, in the reference's order:
    each arch of ``ARCHS`` but paper-350m by each shape of ``SHAPES``,
    long_500k only for ``LONG_CONTEXT_ARCHS`` unless
    ``include_long_skips``."""
    out = []
    for arch in ARCHS:
        if arch == "paper-350m":
            continue
        for shape in SHAPES.values():
            if (shape.name == "long_500k" and not include_long_skips
                    and arch not in LONG_CONTEXT_ARCHS):
                continue
            out.append((arch, shape.name))
    return out


__all__ = ["ACESyncConfig", "ModelConfig", "RunConfig", "SHAPES",
           "ShapeConfig", "ARCHS", "SMOKE_ARCHS", "LONG_CONTEXT_ARCHS",
           "cells"]
