"""recurrentgemma-2b: RG-LRU + local attention hybrid, 1 attn : 2 rec.
[arXiv:2402.19427; hf]

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000,
window=2048, lru_width=2560, GeGLU MLP. Sub-quadratic (a constant-size
recurrent state and windowed attention).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    mlp_kind="geglu",
    period=("rec", "rec", "attn"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    sub_quadratic=True,
)
