"""Architecture registry: the JAX package's ten configs.

Each architecture lives in its own module exporting ``CONFIG``, as in the
JAX package: the transformer families (``dense``, ``moe``, ``vlm``), the
SSM ``mamba2_780m``, the hybrid ``recurrentgemma_2b`` and the enc-dec
``seamless_m4t_large_v2`` (family ``audio``). :func:`input_specs` gives
shape-only (``meta``) stand-ins for every model input of one (arch x shape)
cell of the dry-run: no storage, no values.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, applicable_shapes

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


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str) -> dict[str, torch.Tensor]:
    """Shape-only (``meta``) inputs of one (arch x shape) cell, whole (every rank's rows).

    train:   tokens/labels [B, S(-F)] (+ frontend [B, F or S_enc, D])
    prefill: tokens [B, S(-F)] (+ frontend)
    decode:  token [B, 1] + pos, a 0-dim int32 (the cache comes from
             ``init_cache`` on ``meta``; see :mod:`repro_torch.launch.dryrun`)

    Token ids are int32 and embeddings ``cfg.dtype``, as the JAX package's
    ``ShapeDtypeStruct`` stand-ins.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len

    def tok(ss):
        return torch.empty((b, ss), dtype=torch.int32, device="meta")

    def emb(ss):
        return torch.empty((b, ss, cfg.d_model), dtype=cfg.dtype, device="meta")

    if shape.kind == "decode":
        return {"token": tok(1), "pos": torch.empty((), dtype=torch.int32, device="meta")}
    if cfg.family in ("encdec", "audio"):
        # the stub frontend supplies S_enc frame embeddings; the decoder sees S tokens
        out = {"frontend": emb(s), "tokens": tok(s)}
    elif cfg.frontend_tokens:
        f = cfg.frontend_tokens
        out = {"frontend": emb(f), "tokens": tok(s - f)}
    else:
        out = {"tokens": tok(s)}
    if shape.kind == "train":
        out["labels"] = torch.empty_like(out["tokens"])
    return out


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "all_configs",
    "applicable_shapes",
    "get_config",
    "input_specs",
]
