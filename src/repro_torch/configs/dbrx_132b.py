"""dbrx-132b: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, experts_per_token=4,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    n_experts=4, experts_per_token=2,
    rope_theta=500_000.0,
)
