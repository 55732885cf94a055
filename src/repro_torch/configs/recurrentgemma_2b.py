"""recurrentgemma-2b: 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000,
RG-LRU + local attention (1 attn : 2 rec). [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    sliding_window=2048, lru_width=2560, conv1d_width=4,
    emb_scale_by_dim=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    sliding_window=32, lru_width=64, conv1d_width=4,
    emb_scale_by_dim=True,
)
