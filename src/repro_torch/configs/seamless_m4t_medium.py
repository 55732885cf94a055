"""seamless-m4t-medium: enc-dec 12L(+12L enc) d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206; audio frontend STUBBED (precomputed frame
embeddings per assignment spec). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=256206,
    audio_downsample=8,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256,
    audio_downsample=8,
)
