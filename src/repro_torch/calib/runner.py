"""The calibration pass: tap activations, stream statistics, build the table.

Activation-tap contract: a model forward accepts ``tap(site, x) -> x`` and
calls it on the pre-quantization value at every activation site.
:class:`TapCollector` records those values by name. :func:`collect_stats`
runs a tapped forward over the calibration batches one at a time (a
Python loop where the JAX package scans inside one jit) and folds each
batch into the per-site observers, so no more than one batch of
activations is alive at a time.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from repro_torch.calib.observers import ObserverSummary, init_observer, summarize, update
from repro_torch.calib.policy import CalibrationTable, attach_errors, build_table, fold_cnn_bias


class TapCollector:
    """Records tapped activations by site name during one forward."""

    def __init__(self) -> None:
        self.acts: dict[str, torch.Tensor] = {}

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name in self.acts:
            raise ValueError(f"duplicate tap site {name!r}")
        self.acts[name] = x
        return x


TappedForward = Callable[[torch.Tensor], dict[str, torch.Tensor]]


def collect_stats(
    tapped_forward: TappedForward,
    batches: torch.Tensor,
    *,
    quant_for: Mapping[str, tuple[int, float]] | None = None,
) -> dict[str, ObserverSummary]:
    """Run ``tapped_forward`` over ``batches`` (leading axis = batch index).

    ``quant_for`` maps a site to ``(bits, amax)`` to also accumulate its
    per-channel quantization error under that static quantizer. Sites come
    back in name order, as the JAX package's pytree dict gives them.
    """
    states: dict[str, Any] = {}
    with torch.no_grad():
        for i in range(batches.shape[0]):
            for name, act in tapped_forward(batches[i]).items():
                if name not in states:
                    states[name] = init_observer(act.shape[-1], act.device)
                quant = quant_for.get(name) if quant_for is not None else None
                states[name] = update(states[name], act, quant=quant)
    return {name: summarize(states[name]) for name in sorted(states)}


def calibrate_cnn(
    params: dict,
    spec,
    images: torch.Tensor,
    *,
    bits: int = 8,
    clip: str = "percentile",
    pct: float = 99.9,
    rho_threshold: float = 0.25,
    compensate: bool = True,
) -> tuple[CalibrationTable, dict]:
    """Calibrate a CNN on ``images[n_batches, B, H, W, C]``.

    Returns ``(table, folded_params)``: the static activation quantizers
    and the params with the compensation folded into biases (equal to
    ``params`` when ``compensate`` is off or every rho gate is closed).
    """
    from repro_torch.models import cnn

    def tapped(x):
        tc = TapCollector()
        cnn.forward(params, spec, x, tap=tc)
        return tc.acts

    stats = collect_stats(tapped, images)
    table = build_table(stats, bits=bits, clip=clip, pct=pct, rho_threshold=rho_threshold)
    if not compensate:
        return table, dict(params)
    quant_for = {name: (s.bits, s.amax) for name, s in table.sites}
    errs = collect_stats(tapped, images, quant_for=quant_for)
    table = attach_errors(table, errs)
    return table, fold_cnn_bias(params, spec, table)
