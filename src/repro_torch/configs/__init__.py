"""Architecture registry over the configs ported so far.

Each architecture lives in its own module exporting ``CONFIG``, as in the
JAX package. Here are the configs of the transformer families the port
serves (``dense``, ``moe``, ``vlm``). The recurrent and enc-dec configs
(``mamba2_780m``, ``recurrentgemma_2b``, ``seamless_m4t_large_v2``) follow
with their families (ROADMAP.md, queue 1 item 5, "next").
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "starcoder2_15b",
    "deepseek_7b",
    "yi_34b",
    "qwen3_8b",
    "olmoe_1b_7b",
    "kimi_k2_1t_a32b",
    "internvl2_26b",
)


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"config {arch_id!r} is not ported to repro_torch yet (ported: {ARCH_IDS}); "
            "the ssm, hybrid and audio configs come with their families, ROADMAP.md "
            "(queue 1 item 5, next)"
        )
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "ArchConfig", "all_configs", "get_config"]
