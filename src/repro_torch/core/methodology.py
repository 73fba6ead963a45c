"""Sec. V: the full CoNLoCNN conversion methodology.

Given a trained model (a flat map ``name -> weight`` plus an eval
callback), the loop

  1. finds the critical activation bit-width ``CBW_A``: the lowest
     uniform activation precision whose accuracy loss stays within ``ac``;
  2. computes per-layer scale factors for the chosen ELP_BSD format;
  3. nearest-neighbour-quantizes each layer against its TQL;
  4. runs Algorithm 1 error compensation per layer;
  5. re-evaluates, and while the accuracy constraint is violated walks
     ``CBW_A`` back up toward ``bw_max``.

The same driver as the JAX package's ``core/methodology.py``, on torch
tensors. The returned weights are drop-in dequantized replacements, with
the level records for storage accounting.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core.compensate import compensate_tensor
from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.core.quantize import QuantizedTensor, quantize_tensor

# eval_fn(weights, act_quant) -> accuracy in [0, 1]. ``act_quant`` is None
# (float activations), an int (dynamic-range uniform quantization at that
# bit-width, the paper's FP implementation) or a CalibrationTable (static
# per-layer scales). ``repro_torch.experiments.common.make_eval_fn``
# accepts all three.
EvalFn = Callable[[Mapping[str, torch.Tensor], Any], float]


@dataclasses.dataclass
class ConversionResult:
    weights: dict[str, torch.Tensor]
    quantized: dict[str, QuantizedTensor]
    act_bits: int
    accuracy: float
    baseline_accuracy: float
    encoded_bytes: int
    raw_bytes: int

    @property
    def compression(self) -> float:
        return self.raw_bytes / max(self.encoded_bytes, 1)

    @property
    def accuracy_loss(self) -> float:
        return self.baseline_accuracy - self.accuracy


def find_critical_act_bits(
    eval_fn: EvalFn,
    weights: Mapping[str, torch.Tensor],
    baseline_acc: float,
    ac: float,
    bw_max: int = 8,
    bw_min: int = 2,
    calib=None,
) -> int:
    """Sec. V step 1: the lowest activation bit-width within the loss budget.

    With ``calib`` (a CalibrationTable) ``eval_fn`` receives
    ``calib.with_bits(b)`` instead of a bit-width, so the sweep runs the
    static calibrated quantizers that serve.
    """
    cbw = bw_max
    for bits in range(bw_max, bw_min - 1, -1):
        acc = eval_fn(weights, calib.with_bits(bits) if calib is not None else bits)
        if baseline_acc - acc > ac:
            break
        cbw = bits
    return cbw


def quantize_model(
    weights: Mapping[str, torch.Tensor],
    group_axes: Mapping[str, Sequence[int]],
    fmt: ElpBsdFormat,
    *,
    compensate: bool = True,
    skip: Sequence[str] = (),
) -> tuple[dict[str, torch.Tensor], dict[str, QuantizedTensor]]:
    """Steps 2-4 for every layer: SF -> TQL -> nearest level -> Algorithm 1."""
    out_w: dict[str, torch.Tensor] = {}
    out_q: dict[str, QuantizedTensor] = {}
    for name, w in weights.items():
        if name in skip or w.ndim < 2:
            out_w[name] = w  # biases and norms stay full precision (paper Fig. 3)
            continue
        qt = quantize_tensor(w, fmt)
        if compensate:
            qt = compensate_tensor(w, qt, group_axes.get(name, (0,)))
        out_w[name] = qt.values
        out_q[name] = qt
    return out_w, out_q


def _nbytes(w: torch.Tensor) -> int:
    return w.numel() * w.element_size()


def run_methodology(
    weights: Mapping[str, torch.Tensor],
    group_axes: Mapping[str, Sequence[int]],
    fmt: ElpBsdFormat,
    eval_fn: EvalFn,
    *,
    ac: float = 0.01,
    bw_max: int = 8,
    bw_min: int = 4,
    compensate: bool = True,
    calib=None,
    skip: Sequence[str] = (),
) -> ConversionResult:
    """The full Sec. V loop (the engine behind :func:`repro_torch.api.quantize`).

    ``calib`` switches step 1 and the step-5 walk-back to the calibrated
    static activation path; ``skip`` names weights left at full precision.
    """

    def act_quant(bits: int):
        return calib.with_bits(bits) if calib is not None else bits

    baseline_acc = eval_fn(weights, None)
    cbw = find_critical_act_bits(eval_fn, weights, baseline_acc, ac, bw_max, bw_min, calib=calib)

    qw, qt = quantize_model(weights, group_axes, fmt, compensate=compensate, skip=skip)
    acc = eval_fn(qw, act_quant(cbw))
    # Step 5: walk activation precision back up while the constraint is violated.
    while baseline_acc - acc > ac and cbw < bw_max:
        cbw += 1
        acc = eval_fn(qw, act_quant(cbw))

    raw = sum(_nbytes(w) for w in weights.values())
    enc = sum(q.nbytes_encoded for q in qt.values())
    enc += sum(_nbytes(w) for n, w in weights.items() if n not in qt)
    return ConversionResult(
        weights=qw,
        quantized=qt,
        act_bits=cbw,
        accuracy=acc,
        baseline_accuracy=baseline_acc,
        encoded_bytes=enc,
        raw_bytes=raw,
    )


def convert(
    weights: Mapping[str, torch.Tensor],
    group_axes: Mapping[str, Sequence[int]],
    fmt: ElpBsdFormat,
    eval_fn: EvalFn,
    *,
    ac: float = 0.01,
    bw_max: int = 8,
    bw_min: int = 4,
    compensate: bool = True,
    calib=None,
) -> ConversionResult:
    """Deprecated name for :func:`run_methodology`.

    Model-level callers should use :func:`repro_torch.api.quantize`, which
    drives this loop from a QuantScheme and returns a servable,
    serializable QuantizedModel.
    """
    warnings.warn(
        "repro_torch.core.methodology.convert is deprecated; use repro_torch.api.quantize "
        "(or core.methodology.run_methodology for the raw Sec. V loop)",
        DeprecationWarning,
        stacklevel=2,
    )
    return run_methodology(
        weights, group_axes, fmt, eval_fn, ac=ac, bw_max=bw_max, bw_min=bw_min,
        compensate=compensate, calib=calib,
    )
