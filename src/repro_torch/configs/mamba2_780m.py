"""mamba2-780m: SSD (state-space duality), attention-free. [arXiv:2405.21060]

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128. SSD head structure:
expand=2 gives d_inner=3072, head_dim=64 gives 48 SSD heads. Tied
embeddings (the GPT-NeoX tokenizer, as released). Sub-quadratic.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,
    n_kv_heads=48,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    expand=2,
    ssm_head_dim=64,
    conv_width=4,
    tie_embeddings=True,
    sub_quadratic=True,
)
