"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table).
[arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384e top-8. head_dim = 7168/64 = 112. ~1T total / ~32B active.
No single card holds it; the port runs it at ``reduced()`` only.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    mlp_kind="swiglu",
    n_experts=384,
    topk=8,
    moe_capacity_factor=1.25,
)
