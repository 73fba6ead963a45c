"""Fig. 15(a): error-compensation effectiveness with uniform FP weights.

Paper claim: Algorithm 1 improves accuracy over plain nearest-neighbour
fixed-point quantization, especially at lower bit-widths, with weights and
activations at the same uniform bit-width across layers.

Extended, as in the JAX package, with the activation analogue: static
calibrated activation quantization with the correlation-gated bias-fold
compensation on and off, per-layer output MSE against the float run and
eval accuracy, over the same bit range.

    python -m repro_torch.experiments.fig15a_error_comp [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.calib.runner import calibrate_cnn, per_layer_output_mse
from repro_torch.core.compensate import compensate_tensor
from repro_torch.core.quantize import QuantizedTensor, nn_quantize, uniform_levels
from repro_torch.experiments import common
from repro_torch.models import cnn


def quantize_uniform(params: dict, bits: int, compensate: bool, group_axes: dict) -> dict:
    """Every weight nearest-neighbour quantized to ``bits``-bit uniform levels over
    its own ``max|w|`` (Algorithm 1 on top with ``compensate``); biases kept."""
    out = {}
    for name, w in params.items():
        if name.endswith("_b"):
            out[name] = w
            continue
        levels = uniform_levels(bits, float(torch.max(torch.abs(w))))
        vals, idx = nn_quantize(w, levels)
        qt = QuantizedTensor(values=vals, level_idx=idx, sf=1.0, levels=levels)
        if compensate:
            qt = compensate_tensor(w, qt, group_axes[name])
        out[name] = qt.values
    return out


def run(spec=cnn.ALEXNET_MINI, bit_range=range(2, 9), *, params=None, device=None) -> list[dict]:
    """Eval accuracy, plain and compensated, at each bit-width (weights and
    dynamic activations). ``params`` default to :func:`common.train_mini_cnn`'s."""
    if params is None:
        params = common.train_mini_cnn(spec, device=device)
    eval_fn = common.make_eval_fn(spec, device=device)
    group_axes = cnn.weight_group_axes(params)
    base = eval_fn(params, None)
    rows = [{"bits": "fp32", "plain": base, "compensated": base}]
    for bits in bit_range:
        qp = quantize_uniform(params, bits, False, group_axes)
        qc = quantize_uniform(params, bits, True, group_axes)
        rows.append({"bits": bits, "plain": eval_fn(qp, bits), "compensated": eval_fn(qc, bits)})
    return rows


def run_activation(
    spec=cnn.ALEXNET_MINI, bit_range=range(3, 9), pct=99.5, *, params=None, device=None
) -> list[dict]:
    """Static activation quantization: bias-fold compensation on against off.

    Weights stay float to isolate the activation error; ``mse`` is the sum
    of the per-tap-site MSEs of the quantized forward against the float run.
    """
    if params is None:
        params = common.train_mini_cnn(spec, device=device)
    eval_fn = common.make_eval_fn(spec, device=device)
    images = common.calib_images(spec, device=device)
    x = images[0]
    rows = []
    for bits in bit_range:
        table, folded = calibrate_cnn(params, spec, images, bits=bits, clip="percentile", pct=pct)
        mse_plain = sum(per_layer_output_mse(params, params, spec, x, table).values())
        mse_comp = sum(per_layer_output_mse(params, folded, spec, x, table).values())
        rows.append({
            "bits": bits,
            "acc_plain": eval_fn(params, table),
            "acc_comp": eval_fn(folded, table),
            "mse_plain": mse_plain,
            "mse_comp": mse_comp,
        })
    return rows


def report(rows: list[dict], act: list[dict]) -> None:
    """Print the JAX package's ``name,us,derived`` rows and claim lines."""
    gains = []
    for r in rows:
        d = (r["compensated"] - r["plain"]) if isinstance(r["bits"], int) else 0.0
        gains.append((r["bits"], d))
        common.emit(f"fig15a_b{r['bits']}", 0.0,
                    f"plain={r['plain']:.4f};comp={r['compensated']:.4f};gain={d:+.4f}")
    low = [d for b, d in gains if isinstance(b, int) and b <= 4]
    common.emit("fig15a_claim_lowbit_gain", 0.0, f"mean_gain_le4b={np.mean(low):+.4f}")
    reds = []
    for r in act:
        red = 1.0 - r["mse_comp"] / max(r["mse_plain"], 1e-30)
        reds.append(red)
        common.emit(
            f"fig15a_act_b{r['bits']}", 0.0,
            f"acc_plain={r['acc_plain']:.4f};acc_comp={r['acc_comp']:.4f};"
            f"mse_plain={r['mse_plain']:.5g};mse_comp={r['mse_comp']:.5g};mse_red={red:+.4f}",
        )
    common.emit("fig15a_claim_act_compensation", 0.0,
                f"mean_mse_reduction={np.mean(reds):+.4f};min={min(reds):+.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    params = common.train_mini_cnn(cnn.ALEXNET_MINI, device=args.device)
    report(run(params=params, device=args.device),
           run_activation(params=params, device=args.device))


if __name__ == "__main__":
    main()
