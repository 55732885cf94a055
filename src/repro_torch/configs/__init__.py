"""Architecture configs of the port.  Only the paper's own dense model is
ported so far; the rest of the JAX package's zoo comes in later slices."""
from __future__ import annotations

from repro_torch.configs.base import (ACESyncConfig, ModelConfig, RunConfig,
                                      SHAPES, ShapeConfig)
from repro_torch.configs.paper_350m import CONFIG as paper_350m
from repro_torch.configs.paper_350m import SMOKE as paper_350m_smoke

ARCHS = {"paper-350m": paper_350m}
SMOKE_ARCHS = {"paper-350m": paper_350m_smoke}

__all__ = ["ACESyncConfig", "ModelConfig", "RunConfig", "SHAPES",
           "ShapeConfig", "ARCHS", "SMOKE_ARCHS"]
