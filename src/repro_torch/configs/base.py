"""Config schema: the decoder-LM architecture description.

An :class:`ArchConfig` is the JAX package's frozen, hashable description
of a model, field for field, so a config written for one package reads
the same in the other. ``dtype`` maps ``dtype_str`` to a torch dtype, and
``reduced()`` derives the CPU-sized variant of the same family (same code
paths, tiny dims).

The JAX package's ``input_specs`` (abstract inputs for its XLA dry-run)
has no counterpart here: the port runs eagerly and lowers nothing.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    topk: int = 0
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    period: tuple[str, ...] = ()
    window: int = 0  # local attention window (0 = global)
    lru_width: int = 0
    # --- enc-dec ---
    n_dec_layers: int = 0  # 0 -> decoder-only
    # --- modality frontend stub (vlm / audio) ---
    frontend_tokens: int = 0
    dtype_str: str = "bfloat16"
    sub_quadratic: bool = False
    moe_capacity_factor: float = 1.25

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.dtype_str]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        per_ff = 3 if self.mlp_kind == "swiglu" else 2
        if self.is_moe:
            ffn = self.n_experts * per_ff * d * self.d_ff + d * self.n_experts
        else:
            ffn = per_ff * d * self.d_ff
        block = attn + ffn
        if self.family == "ssm":
            d_in = self.expand * d
            block = d * (2 * d_in + 2 * self.ssm_state) + d_in * d + d_in * 2
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + (self.n_layers + self.n_dec_layers) * block

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the JAX package's dims)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.period else len(self.period)),
            n_dec_layers=min(self.n_dec_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 8),
            topk=min(self.topk, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            lru_width=64 if self.lru_width else 0,
            window=min(self.window, 32),
            frontend_tokens=min(self.frontend_tokens, 8),
            dtype_str="float32",
        )
