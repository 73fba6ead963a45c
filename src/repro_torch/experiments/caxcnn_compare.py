"""Sec. VI-D: CoNLoCNN against CAxCNN (reduced-precision CSD baseline).

CAxCNN's best conversion (exhaustive search) over the one-non-zero-digit
CA representation is nearest-neighbour search on the 17 levels
{0, +-2^s} (5 bits a weight), here with the ELP_BSD max-alignment scale
factor. CoNLoCNN is ELP_BSD{SF,[1,0..7]} (16 levels, 4 bits a weight, no
zero) with Algorithm 1. Paper: CoNLoCNN about 4.5 % top-1 ahead on
AlexNet, with one bit fewer a weight. Evaluated, as in the JAX package's
``benchmarks/caxcnn_compare.py``, on the hard-margin eval (``amp=0.45``)
with dynamic 8-bit activations, plus each quantized network's logit MSE
against the float one.

    python -m repro_torch.experiments.caxcnn_compare [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import FORMAT_A, ca_levels
from repro_torch.core.compensate import compensate_tensor
from repro_torch.core.methodology import quantize_model
from repro_torch.core.quantize import QuantizedTensor, nn_quantize, scale_factor
from repro_torch.device import resolve_device
from repro_torch.experiments import common
from repro_torch.models import cnn


def quantize_ca(params: dict, group_axes: dict, compensate: bool = False) -> dict:
    """Every weight nearest-neighbour quantized to ``ca_levels(3) * SF`` (SF by the
    ELP_BSD a4 rule; Algorithm 1 on top with ``compensate``); biases kept."""
    out = {}
    for name, w in params.items():
        if name.endswith("_b"):
            out[name] = w
            continue
        sf = scale_factor(w, FORMAT_A)
        levels = torch.as_tensor(ca_levels(3), dtype=torch.float32, device=w.device) * sf
        vals, idx = nn_quantize(w, levels)
        qt = QuantizedTensor(values=vals, level_idx=idx, sf=sf, levels=levels)
        if compensate:
            qt = compensate_tensor(w, qt, group_axes[name])
        out[name] = qt.values
    return out


def _logit_mse(spec, base_params: dict, q_params: dict, seed: int = 0) -> float:
    """Output fidelity: MSE of the quantized network's logits against the float
    network's, on one batch of the task (index 77000)."""
    device = next(iter(base_params.values())).device
    ds = common.CnnDataset(spec.input_hw, spec.input_ch, common.N_CLASSES, common.BATCH,
                           seed=seed)
    x = torch.from_numpy(ds.np_batch(77_000)[0]).to(device)
    with torch.no_grad():
        lb = cnn.forward(base_params, spec, x)
        lq = cnn.forward(q_params, spec, x)
    return float(torch.mean(torch.square(lb - lq)))


def run(spec=cnn.ALEXNET_MINI, *, params=None, device=None) -> dict:
    """Baseline, CAxCNN (5 bits) and CoNLoCNN (a4, Algorithm 1) accuracies at dynamic
    8-bit activations, and both logit MSEs. ``params`` default to
    :func:`common.train_mini_cnn`'s."""
    device = resolve_device(device)
    if params is None:
        params = common.train_mini_cnn(spec, device=device)
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    # hard-margin eval: the same task at a lower SNR, so quantization noise shows
    eval_fn = common.make_eval_fn(spec, amp=0.45, device=device)
    ga = cnn.weight_group_axes(params)
    cax_w = quantize_ca(params, ga, compensate=False)
    conlo_w, _ = quantize_model(params, ga, FORMAT_A, compensate=True)
    return {
        "baseline": eval_fn(params, None),
        "caxcnn_5b": eval_fn(cax_w, 8),
        "conlocnn_4b": eval_fn(conlo_w, 8),
        "mse_cax": _logit_mse(spec, params, cax_w),
        "mse_conlo": _logit_mse(spec, params, conlo_w),
    }


def report(r: dict) -> None:
    """Print the JAX package's ``caxcnn_compare`` row."""
    common.emit(
        "caxcnn_compare",
        0.0,
        f"baseline={r['baseline']:.4f};caxcnn_ca1_5b={r['caxcnn_5b']:.4f};"
        f"conlocnn_a4_4b={r['conlocnn_4b']:.4f};delta={r['conlocnn_4b'] - r['caxcnn_5b']:+.4f};"
        f"logit_mse_cax={r['mse_cax']:.4f};logit_mse_conlo={r['mse_conlo']:.4f}",
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    report(run(device=ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
