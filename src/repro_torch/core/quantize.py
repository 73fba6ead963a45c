"""Quantization primitives (paper Sec. V steps 1-3) on torch tensors.

Nearest-neighbour search against a sorted level table, the Algorithm 1
flip target, and symmetric uniform fake quantization for activations.
Level tables are float64 numpy on the host and enter the arithmetic as
float32 tensors, as they do in the JAX package, so the same inputs give
the same indices bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _levels_tensor(levels: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(levels, np.float32), device=device)


def nn_quantize_idx(w: torch.Tensor, levels: np.ndarray) -> torch.Tensor:
    """Index of the nearest level for each element; ties go to the lower level."""
    lv = _levels_tensor(levels, w.device)
    mid = (lv[1:] + lv[:-1]) / 2.0
    return torch.searchsorted(mid, w.to(torch.float32).contiguous(), right=True).to(torch.int32)


def second_neighbor_idx(w: torch.Tensor, levels: np.ndarray, nn_idx: torch.Tensor) -> torch.Tensor:
    """Index of the level on the other side of ``w`` from its nearest level.

    At the table edges the nearest index itself is returned.
    """
    lv = _levels_tensor(levels, w.device)
    n = lv.shape[0]
    nn = nn_idx.long()
    other = torch.where(w.to(torch.float32) >= lv[nn], nn + 1, nn - 1)
    valid = (other >= 0) & (other <= n - 1)
    return torch.where(valid, other, nn).to(torch.int32)


def _check_uniform_bits(bits: int) -> None:
    """Symmetric uniform quantization needs ``bits >= 2`` (1 bit has no level)."""
    if not isinstance(bits, (int, np.integer)) or isinstance(bits, bool):
        raise TypeError(f"bits must be an int, got {type(bits).__name__}")
    if bits < 2:
        raise ValueError(
            f"symmetric uniform quantization requires bits >= 2, got {bits} "
            "(bits=1 has zero quantization levels)"
        )


def fake_quant_uniform(
    x: torch.Tensor, bits: int, max_abs: "float | torch.Tensor"
) -> torch.Tensor:
    """Simulated symmetric fixed-point quantization (round half to even)."""
    _check_uniform_bits(bits)
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(
        torch.as_tensor(max_abs, dtype=torch.float32, device=x.device), min=1e-12
    ) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return (q * scale).to(x.dtype)


def fake_quant_dynamic(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor dynamic-range activation quantization (runtime scale)."""
    return fake_quant_uniform(x, bits, torch.max(torch.abs(x)))
