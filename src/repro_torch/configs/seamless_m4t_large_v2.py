"""seamless-m4t-large-v2: enc-dec multimodal backbone. [arXiv:2308.11596; hf]

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206, read as 24 encoder
+ 24 decoder layers (the released large-v2 text stacks). The speech
frontend is a stub: callers supply precomputed frame embeddings, which
feed the encoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    mlp_kind="gelu",
)
