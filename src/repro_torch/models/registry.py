"""Architecture registry of the port: ``--arch <id>`` -> model, for every
family of the JAX package's zoo.  The dense family (paper-350m and the
dense zoo: qwen3-8b, gemma2-9b, minitron-8b, starcoder2-3b, and the VLM
llava-next-mistral-7b, the dense stack behind its vision stub), the MoE
family (qwen3-moe-30b-a3b, dbrx-132b), the SSM (falcon-mamba-7b), the
RG-LRU hybrid (recurrentgemma-2b) and the encoder-decoder
(seamless-m4t-medium).  Every family also builds sharded over a
within-pod ("data", "model") mesh."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.encdec import EncDecTransformer
from repro_torch.models.mamba import MambaLM
from repro_torch.models.rglru import GriffinLM
from repro_torch.models.shardctx import ShardCtx
from repro_torch.models.transformer import DenseTransformer, MoETransformer

_FAMILY_CLS = {"dense": DenseTransformer, "moe": MoETransformer,
               "ssm": MambaLM, "hybrid": GriffinLM,
               "encdec": EncDecTransformer}


def build_model(cfg: ModelConfig, run: Optional[RunConfig] = None,
                device="cuda", ctx: Optional[ShardCtx] = None):
    """``cfg``'s model; ``ctx`` shards it over a ("data", "model") mesh
    (every family; a mesh that does not split its heads, K/V heads,
    d_ff, channels or vocabulary raises ``ValueError``)."""
    try:
        cls = _FAMILY_CLS[cfg.family]
    except KeyError:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet") from None
    return cls(cfg, run, device=device, ctx=ctx)
