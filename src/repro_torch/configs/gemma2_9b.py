"""gemma2-9b: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
local+global alternating, logit softcaps, post-norms. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    layer_pattern="local_global", sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norms=True, emb_scale_by_dim=True,
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern="local_global", sliding_window=32,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norms=True, emb_scale_by_dim=True,
)
