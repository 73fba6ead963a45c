"""The calibration pass: tap activations, stream statistics, build the table.

Activation-tap contract: a model forward accepts ``tap(site, x) -> x`` and
calls it on the pre-quantization value at every activation site.
:class:`TapCollector` records those values by name. :func:`collect_stats`
runs a tapped forward over the calibration batches one at a time (a
Python loop where the JAX package scans inside one jit) and folds each
batch into the per-site observers, so no more than one batch of
activations is alive at a time.

:func:`calibrate_cnn` and :func:`calibrate_lm` are the model front ends
(stats pass, then the policy's scales and rho gates; for CNNs the bias
fold); :func:`calibrate_kv_cache` gives an LM's static K/V cache scales.
:func:`per_layer_output_mse` measures what a table costs a CNN, site by site,
and :func:`count_range_reductions` checks the zero range-reduction contract
(DESIGN.md §6) on any forward.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
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


def calibrate_lm(
    params: Any,
    cfg,
    token_batches: torch.Tensor,
    *,
    bits: int = 8,
    clip: str = "percentile",
    pct: float = 99.9,
    rho_threshold: float = 0.25,
) -> CalibrationTable:
    """Calibrate a decoder LM on ``token_batches[n_batches, B, S]``.

    Taps the embedding output, the stacked per-layer residual streams
    (``"blocks"``), the per-matmul input sites (``"attn_in"``,
    ``"attn_mix"``, ``"ffn_in"``, and for a dense MLP ``"ffn_hidden"``)
    and the final pre-unembed activation of the cache-less token-only
    forward; the packed weights' static activation scales are resolved
    against these sites (:func:`repro_torch.api_schemes.stamp_lm_act`).
    """
    from repro_torch.models import transformer

    def tapped(tokens):
        tc = TapCollector()
        transformer.forward(params, cfg, tokens, tap=tc)
        return tc.acts

    stats = collect_stats(tapped, token_batches)
    return build_table(stats, bits=bits, clip=clip, pct=pct, rho_threshold=rho_threshold)


def calibrate_kv_cache(
    params: Any, cfg, token_batches: torch.Tensor, *, bits: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Static per-(layer, kv head) K/V cache scales from ``[n, B, S]`` tokens.

    Observes the ``k_cache``/``v_cache`` tap sites (post-RoPE keys and
    values, what a serving cache stores). Each ``[L, B, S, KV, hd]`` stack is
    laid out channels-last as ``[B, S, hd, L*KV]``, as in the JAX package,
    so the per-channel running max is one amax per (layer, kv head).
    Returns ``(k_scale, v_scale)``, each ``[L, KV]`` float32:
    ``amax / (2^(bits-1) - 1)``.
    """
    from repro_torch.models import transformer

    n_layers = cfg.n_dec_layers or cfg.n_layers
    n_kv = cfg.n_kv_heads

    def chan(x):  # [L, B, S, KV, hd] -> [B, S, hd, L*KV]
        x = x.permute(1, 2, 4, 0, 3)
        return x.reshape(x.shape[0], x.shape[1], x.shape[2], -1)

    def tapped(tokens):
        tc = TapCollector()
        transformer.forward(params, cfg, tokens, tap=tc, tap_kv=True)
        return {"k_cache": chan(tc.acts["k_cache"]), "v_cache": chan(tc.acts["v_cache"])}

    stats = collect_stats(tapped, token_batches)
    qmax = float(2 ** (bits - 1) - 1)

    def scales(summary: ObserverSummary) -> np.ndarray:
        amax = np.maximum(np.asarray(summary.ch_amax, np.float32), 1e-8)
        return (amax.reshape(n_layers, n_kv) / qmax).astype(np.float32)

    return scales(stats["k_cache"]), scales(stats["v_cache"])


def per_layer_output_mse(
    params: dict, quant_params: dict, spec, x: torch.Tensor, table: CalibrationTable
) -> dict[str, float]:
    """Per-site MSE of the calibrated-quantized forward against the float run.

    ``quant_params`` may be the bias-folded params: each tap site's error
    reflects everything quantized upstream of it, so folding site N's
    compensation shows at site N+1.
    """
    from repro_torch.models import cnn

    def run(p, calib):
        tc = TapCollector()
        with torch.no_grad():
            cnn.forward(p, spec, x, calib=calib, tap=tc)
        return tc.acts

    acts_fp = run(params, None)
    acts_q = run(quant_params, table)
    return {name: float(torch.mean(torch.square(acts_q[name] - acts_fp[name])))
            for name in acts_fp}


# The ATen reductions that take a runtime range (max |x| and the like). The
# elementwise overloads of max/min (``maximum``'s "other" and its out form)
# are not reductions.
_RANGE_OPS = ("amax", "amin", "aminmax", "max", "min")
_ELEMENTWISE_OVERLOADS = ("other", "out")


def count_range_reductions(fn: Callable, *args, **kwargs) -> int:
    """Number of range reductions the call ``fn(*args, **kwargs)`` dispatches.

    The acceptance gauge of static activation quantization (DESIGN.md §6):
    a dynamic ``max|x|`` is an ``amax``/``amin``/``aminmax`` or a reducing
    ``max``/``min`` ATen op, counted here by a
    ``TorchDispatchMode`` as the call runs; model ops are not (max-pool is
    ``max_pool2d``, relu and clamps elementwise, softmax one fused op), so
    a calibrated forward counts zero. The JAX package counts ``reduce_max``
    in the jaxpr instead. Custom kernels launched outside ATen (the CUDA
    matmuls) are not seen; their inputs' quantization is.
    """
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (func.overloadpacket.__name__ in _RANGE_OPS
                    and func._overloadname not in _ELEMENTWISE_OVERLOADS):
                self.n += 1
            return func(*args, **(kwargs or {}))

    counter = _Counter()
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return counter.n
