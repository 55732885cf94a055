"""minitron-8b: 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000,
pruned nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)
