"""olmoe-1b-7b — 64-expert top-8 MoE. [arXiv:2409.02060; hf]

16L d_model=2048 16H (kv=16, MHA) expert d_ff=1024 vocab=50304,
MoE 64e top-8. SwiGLU experts; every layer is MoE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    mlp_kind="swiglu",
    n_experts=64,
    topk=8,
)
