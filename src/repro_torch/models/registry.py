"""Architecture registry of the port: ``--arch <id>`` -> model.  Dense
only for now; the JAX package's other families come in later slices."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.transformer import DenseTransformer

_FAMILY_CLS = {"dense": DenseTransformer}


def build_model(cfg: ModelConfig, run: Optional[RunConfig] = None,
                device="cuda"):
    try:
        cls = _FAMILY_CLS[cfg.family]
    except KeyError:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet") from None
    return cls(cfg, run, device=device)
