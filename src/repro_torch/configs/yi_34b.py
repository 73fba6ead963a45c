"""yi-34b — llama-architecture GQA decoder. [arXiv:2403.04652; hf]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. SwiGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    mlp_kind="swiglu",
    rope_theta=5e6,
)
