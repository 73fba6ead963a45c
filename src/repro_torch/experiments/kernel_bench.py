"""Kernel microbenchmark: the packed decode + matmul against a bf16 ``torch.matmul``.

The JAX package's ``benchmarks/kernel_bench.py`` on the port. At its two
shapes, bf16 activations go through ``quantized_matmul(impl="auto")`` on a4
and c6 codes (without Algorithm 1, as there): the autotune cache's winner,
else the decode-step kernel up to 256 rows, on the card the wgmma routes.
Each row is ``name,us,derived`` with the bf16 ``torch.matmul`` on the
unquantized weight, the HBM weight-byte ratio (exact) and the byte counts.
Times are CUDA events around each call on the card; on the CPU the kernels
run their plain versions and the times say nothing about the card.

    python -m repro_torch.experiments.kernel_bench [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import FORMAT_A, FORMAT_C
from repro_torch.device import resolve_device
from repro_torch.experiments import common
from repro_torch.kernels.ops import pack_weight, quantized_matmul

SHAPES = [(256, 2048, 2048), (128, 4096, 4096)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m, k, n in SHAPES:
            x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
                device, torch.bfloat16)
            w = torch.from_numpy((rng.normal(size=(k, n)) * 0.02).astype(np.float32)).to(device)
            wb = w.to(torch.bfloat16)
            t_base = common.timed(torch.matmul, x, wb, device=device)
            for fmt in (FORMAT_A, FORMAT_C):
                pw, _ = pack_weight(w, fmt, compensate=False)
                t = common.timed(lambda a, p=pw: quantized_matmul(a, p, out_dtype=torch.bfloat16),
                                 x, device=device)
                ratio = (k * n * 2) / pw.nbytes
                common.emit(
                    f"kernel_{fmt.name}_{m}x{k}x{n}",
                    t,
                    f"bf16_us={t_base:.0f};hbm_weight_ratio={ratio:.1f}x;"
                    f"weight_bytes={pw.nbytes};bf16_bytes={k * n * 2}",
                )


if __name__ == "__main__":
    main()
