"""llava-next-mistral-7b: mistral-7b backbone 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000; anyres vision frontend STUBBED (precomputed patch
embeddings per assignment spec). [hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    rope_theta=1_000_000.0,
    frontend="vision_stub", n_patches=576,
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    frontend="vision_stub", n_patches=8,
)
