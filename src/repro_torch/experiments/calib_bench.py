"""Dynamic against static activation quantization on the packed CNN forward.

The dynamic path (the paper's FP implementation, Sec. V step 1) pays a
per-site ``max|x|`` reduction at every forward; the calibrated path runs
the same uniform quantizers against scales fixed at conversion. On the
packed forward (ELP_BSD c6 weights, im2col convs; on the card the decode
runs inside the matmul kernels) this measures, as the JAX package's
``benchmarks/calib_bench.py`` does:

  * time per batch with float, dynamic and static activations (median of
    5 after a warm-up; CUDA events on the card, the host clock on the CPU);
  * the range reductions each forward dispatches
    (:func:`repro_torch.calib.runner.count_range_reductions`; the static
    path must count zero);
  * the one-off conversion time: the whole ``api.quantize`` call
    (calibration pass, bias fold, packing).

    python -m repro_torch.experiments.calib_bench [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import api
from repro_torch.calib.runner import count_range_reductions
from repro_torch.device import resolve_device
from repro_torch.experiments import common
from repro_torch.models import cnn


def run(spec=cnn.ALEXNET_MINI, bits: int = 8, fmt: str = "elp_bsd_c6", *, params=None,
        device=None) -> dict:
    """Conversion ms, float/dynamic/static forward us and each forward's range
    reductions on the first calibration batch. ``params`` default to
    :func:`common.train_mini_cnn`'s."""
    device = resolve_device(device)
    if params is None:
        params = common.train_mini_cnn(spec, device=device)
    images = common.calib_images(spec, device=device)
    x = images[0]

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    qm = api.quantize(spec, params, api.QuantScheme(fmt=fmt, act="static", act_bits=bits),
                      calib_data=images, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    convert_ms = (time.perf_counter() - t0) * 1e3
    table, qparams = qm.table, qm.params

    def fwd_fp(xx):
        with torch.no_grad():
            return cnn.forward(qparams, spec, xx)

    def fwd_dyn(xx):
        with torch.no_grad():
            return cnn.forward(qparams, spec, xx, act_bits=bits)

    def fwd_static(xx):
        with torch.no_grad():
            return cnn.forward(qparams, spec, xx, calib=table)

    return {
        "convert_ms": convert_ms,
        "us_fp": common.timed(fwd_fp, x, device=device),
        "us_dynamic": common.timed(fwd_dyn, x, device=device),
        "us_static": common.timed(fwd_static, x, device=device),
        "reduce_max_dynamic": count_range_reductions(fwd_dyn, x),
        "reduce_max_static": count_range_reductions(fwd_static, x),
    }


def report(spec, r: dict) -> None:
    """Print the JAX package's three ``calib_bench`` rows for ``spec``."""
    common.emit(f"calib_bench_{spec.name}_dynamic", r["us_dynamic"],
                f"reduce_max={r['reduce_max_dynamic']}")
    common.emit(f"calib_bench_{spec.name}_static", r["us_static"],
                f"reduce_max={r['reduce_max_static']};speedup_vs_dynamic="
                f"{r['us_dynamic'] / max(r['us_static'], 1e-9):.3f}x")
    common.emit(f"calib_bench_{spec.name}_overheads", r["us_fp"],
                f"convert_ms={r['convert_ms']:.1f};act_quant_cost_static="
                f"{r['us_static'] - r['us_fp']:+.1f}us;act_quant_cost_dynamic="
                f"{r['us_dynamic'] - r['us_fp']:+.1f}us")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = ap.parse_args(argv).device
    for spec in (cnn.ALEXNET_MINI, cnn.VGG_MINI):
        report(spec, run(spec, device=device))


if __name__ == "__main__":
    main()
