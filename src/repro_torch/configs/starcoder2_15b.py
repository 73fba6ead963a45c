"""starcoder2-15b — dense GQA decoder. [arXiv:2402.19173; hf]

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. Plain GELU MLP
(StarCoder2 uses an ungated FFN), RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    mlp_kind="gelu",
    rope_theta=1e5,
)
