"""internvl2-26b — InternViT + InternLM2 VLM. [arXiv:2404.16821; hf]

Backbone only (per assignment): the InternLM2-20B LM — 48L d_model=6144
48H (GQA kv=8) d_ff=16384 vocab=92553, SwiGLU. The InternViT frontend
is a STUB: ``input_specs()`` provides 256 precomputed patch embeddings
prepended to the text stream.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    mlp_kind="swiglu",
    frontend_tokens=256,
    rope_theta=1e6,
)
