"""Quantization primitives (paper Sec. V steps 1-3) on torch tensors.

The per-layer scale factor ``SF = max|W| / 2^{max shift}``, the table of
quantization levels ``TQL = SF * levels``, nearest-neighbour search
against a sorted level table, the Algorithm 1 flip target, symmetric
uniform fake quantization for activations, and the layer record
:class:`QuantizedTensor` that the Sec. V loop carries. Level tables are
float64 numpy on the host (or a float32 tensor, a TQL scaled on the
device) and enter the arithmetic as float32, as they do in the JAX
package, so the same inputs give the same indices bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.elp_bsd import ElpBsdFormat, storage_bytes


def _levels_tensor(levels: "np.ndarray | torch.Tensor", device: torch.device) -> torch.Tensor:
    if isinstance(levels, torch.Tensor):
        return levels.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(levels, np.float32), device=device)


def scale_factor(w: torch.Tensor, fmt: ElpBsdFormat) -> torch.Tensor:
    """Per-layer scale factor ``SF = max|W| / 2^{max shift}`` (Sec. V), a float32 scalar.

    All-zero tensors get SF = 1e-20, as in the conversion engine, so they
    dequantize to ~0 even for formats without a zero level.
    """
    mx = torch.max(torch.abs(w.to(torch.float32)))
    return torch.clamp(mx / (2.0**fmt.max_shift), min=1e-20).to(torch.float32)


def tql(fmt: ElpBsdFormat, sf: "float | torch.Tensor") -> "np.ndarray | torch.Tensor":
    """Table of quantization levels for one layer: ``SF * levels``.

    A host float ``sf`` gives a float64 numpy table, a tensor ``sf`` (from
    :func:`scale_factor`) a float32 tensor on its device.
    """
    if isinstance(sf, (int, float)):
        return (fmt.levels() * sf).astype(np.float64)
    return torch.as_tensor(fmt.levels().astype(np.float32), device=sf.device) * sf


def nn_quantize_idx(w: torch.Tensor, levels: np.ndarray) -> torch.Tensor:
    """Index of the nearest level for each element; ties go to the lower level."""
    lv = _levels_tensor(levels, w.device)
    mid = (lv[1:] + lv[:-1]) / 2.0
    return torch.searchsorted(mid, w.to(torch.float32).contiguous(), right=True).to(torch.int32)


def nn_quantize(
    w: torch.Tensor, levels: "np.ndarray | torch.Tensor"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour quantization: (quantized values in ``w``'s dtype, indices)."""
    idx = nn_quantize_idx(w, levels)
    return _levels_tensor(levels, w.device)[idx.long()].to(w.dtype), idx


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


def uniform_levels(bits: int, max_abs: float) -> np.ndarray:
    """Symmetric uniform (fixed-point) level table with ``2^bits - 1`` levels."""
    _check_uniform_bits(bits)
    qmax = 2 ** (bits - 1) - 1
    step = max_abs / qmax
    return np.arange(-qmax, qmax + 1, dtype=np.float64) * step


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


def ca_levels(n_shift_bits: int = 3, include_zero: bool = True) -> np.ndarray:
    """Canonical-approximate levels of the CAxCNN baseline (Sec. VI-D):
    ``{0} U {+-2^s : s in 0 .. 2^n_shift_bits - 1}``, sorted float64.

    With ``n_shift_bits=3`` these are the 17 levels (5 bits a weight) of the
    one-non-zero-digit CA representation; its exhaustive-search conversion
    is nearest-neighbour search on this table.
    """
    mags = np.exp2(np.arange(0, 2 ** n_shift_bits).astype(np.float64))
    lv = np.concatenate([-mags, mags, [0.0]] if include_zero else [-mags, mags])
    return np.unique(lv)


@dataclasses.dataclass
class QuantizedTensor:
    """A weight tensor quantized against a per-layer TQL.

    Attributes:
      values: dequantized (float) values, drop-in replacement weights.
      level_idx: index into the TQL per element (int32).
      sf: the layer scale factor (a float32 scalar tensor, or 1.0 for a
        uniform baseline).
      levels: the scaled level table (host numpy or a float32 tensor).
      fmt: the ELP_BSD format (None for the uniform baselines).
    """

    values: torch.Tensor
    level_idx: torch.Tensor
    sf: "float | torch.Tensor"
    levels: "np.ndarray | torch.Tensor"
    fmt: ElpBsdFormat | None = None

    @property
    def nbytes_encoded(self) -> int:
        n = self.values.numel()
        if self.fmt is None:
            # uniform baseline stored at ceil(log2(n_levels)) bits
            bits = int(np.ceil(np.log2(len(self.levels))))
            return (n * bits + 7) // 8
        return storage_bytes(n, self.fmt)


def quantize_tensor(w: torch.Tensor, fmt: ElpBsdFormat) -> QuantizedTensor:
    """Sec. V steps 2-3 for one tensor: SF -> TQL -> nearest-neighbour quantization.

    The conversion engine (:mod:`repro_torch.core.convert`) at per-tensor
    granularity, without Algorithm 1.
    """
    from repro_torch.core.convert import convert_tensor  # circular-import guard

    ct = convert_tensor(w, fmt, granularity="per_tensor", compensate=False)
    sf = ct.sf.reshape(())
    return QuantizedTensor(
        values=ct.values.to(w.dtype),
        level_idx=ct.level_idx,
        sf=sf,
        levels=tql(fmt, sf),
        fmt=fmt,
    )
