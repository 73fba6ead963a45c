"""Carry weights across from the JAX package, given as numpy.

The JAX package and this port use the same layouts (NHWC activations,
HWIO conv weights, ``[in, out]`` fc weights, ``[K, N]`` or nibble
``[ceil(K/2), N]`` codes), so a parameter dict or a packed weight moves
across as its arrays. Nothing here imports the JAX package: the caller
hands over ``np.asarray`` of its leaves.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import PackedWeight


def params_from_numpy(tree: Mapping[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """A flat JAX parameter dict (numpy leaves) -> the port's dict of tensors on ``device``."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tree.items()}


def packed_from_numpy(
    codes: np.ndarray,
    sf: np.ndarray,
    fmt_name: str,
    nibble: bool,
    shape: tuple[int, int],
    source_shape: tuple[int, ...] | None = None,
    act_scale: float | None = None,
    act_bits: int | None = None,
    *,
    device=None,
) -> PackedWeight:
    """A :class:`PackedWeight` from the JAX package's numpy codes and scale factors."""
    device = resolve_device(device)
    codes = np.asarray(codes)
    if codes.dtype != np.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    return PackedWeight(
        codes=torch.from_numpy(np.array(codes)).to(device),
        sf=torch.from_numpy(np.array(sf, dtype=np.float32)).to(device),
        fmt_name=fmt_name,
        nibble=bool(nibble),
        shape=(int(shape[0]), int(shape[1])),
        source_shape=tuple(int(s) for s in source_shape) if source_shape is not None else None,
        act_scale=act_scale,
        act_bits=act_bits,
    )
