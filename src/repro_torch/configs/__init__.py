"""Architecture registry over the configs ported so far.

Each architecture lives in its own module exporting ``CONFIG``, as in the
JAX package. Only the decoder-LM configs the port serves are here; the
rest of the JAX package's registry follows with their families
(ROADMAP.md, queue 1 item 5).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = ("qwen3_8b",)


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"config {arch_id!r} is not ported to repro_torch yet (ported: {ARCH_IDS}); "
            "see ROADMAP.md (queue 1 item 5)"
        )
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


__all__ = ["ARCH_IDS", "ArchConfig", "get_config"]
