"""Architecture registry: the JAX package's ten configs.

Each architecture lives in its own module exporting ``CONFIG``, as in the
JAX package: the transformer families (``dense``, ``moe``, ``vlm``), the
SSM ``mamba2_780m``, the hybrid ``recurrentgemma_2b`` and the enc-dec
``seamless_m4t_large_v2`` (family ``audio``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "mamba2_780m",
    "starcoder2_15b",
    "deepseek_7b",
    "yi_34b",
    "qwen3_8b",
    "olmoe_1b_7b",
    "kimi_k2_1t_a32b",
    "recurrentgemma_2b",
    "seamless_m4t_large_v2",
    "internvl2_26b",
)


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown config {arch_id!r} (known: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "ArchConfig", "all_configs", "get_config"]
