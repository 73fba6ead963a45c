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


def _static_step(max_abs: float, qmax: float, device: torch.device) -> torch.Tensor:
    """The float32 step ``max(max_abs, 1e-12) / qmax`` of a static quantizer, on ``device``."""
    step = np.maximum(np.float32(max_abs), np.float32(1e-12)) / np.float32(qmax)
    return torch.full((), float(step), dtype=torch.float32, device=device)


def fake_quant_uniform(
    x: torch.Tensor, bits: int, max_abs: "float | torch.Tensor"
) -> torch.Tensor:
    """Simulated symmetric fixed-point quantization (round half to even).

    The step and the rounding are float32 whatever ``x``'s dtype, as in the
    JAX package (its float32 scale promotes a bfloat16 ``x``). A Python
    ``max_abs`` (a calibrated static scale) gives the same float32 step,
    computed on the host and filled into a device tensor (a Python divisor
    would make the card multiply by its reciprocal, which rounds otherwise).
    """
    _check_uniform_bits(bits)
    qmax = float(2 ** (bits - 1) - 1)
    if isinstance(max_abs, torch.Tensor):
        scale = torch.clamp(max_abs.to(device=x.device, dtype=torch.float32), min=1e-12) / qmax
    else:
        scale = _static_step(float(max_abs), qmax, x.device)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax, qmax)
    return (q * scale).to(x.dtype)


def fake_quant_dynamic(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor dynamic-range activation quantization (runtime scale)."""
    return fake_quant_uniform(x, bits, torch.max(torch.abs(x)))
