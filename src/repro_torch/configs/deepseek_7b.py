"""deepseek-7b — llama-architecture dense decoder. [arXiv:2401.02954; hf]

30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400. SwiGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    head_dim=128,
    mlp_kind="swiglu",
)
