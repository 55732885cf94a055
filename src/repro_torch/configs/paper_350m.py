"""The paper's own workload: a 350M-parameter transformer LM (section 4.2),
batch 64 per edge node, AdamW, seq 512-1024."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-350m", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=50304,
)

SMOKE = ModelConfig(
    name="paper-350m-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
)
