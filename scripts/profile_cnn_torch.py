#!/usr/bin/env python3
"""Where a packed AlexNet forward at batch 64 spends its time on one NVIDIA GPU.

Builds the port's kernels, converts seeded full-width AlexNet weights as
``chip_smoke.py`` does (``api.quantize``, a4 nibble codes, static 8-bit
activations calibrated on 2 x 16 seeded images), then traces one forward
of 64 seeded images with ``torch.profiler`` and prints the host-clock
time, the summed device time of the kernels the trace recorded, the
device's idle share, the device kernels that took the most time, the
launches of each kernel route, and the host-side operations that took
the most host time.

    python3 scripts/profile_cnn_torch.py

Needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
BATCH = 64


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_cnn_torch: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from profile_lm_torch import kernel_summary
    from repro_torch import _build, api
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.fused_decode import fused_decode_matmul
    from repro_torch.models import cnn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    _build.build(list(_build.SOURCES))
    dev = torch.device("cuda")
    params = cnn.init_params(cnn.ALEXNET, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = torch.randn(2, 16, 224, 224, 3, device=dev, generator=gen)
    batch = torch.randn(BATCH, 224, 224, 3, device=dev, generator=gen)
    scheme = api.QuantScheme(fmt="elp_bsd_a4", act="static", act_bits=8)
    qm = api.quantize(cnn.ALEXNET, params, scheme, calib_data=calib)
    qm.forward(batch)  # warm-up
    torch.cuda.synchronize()

    wrappers = {"elp_bsd_matmul": elp_bsd_matmul, "fused_decode_matmul": fused_decode_matmul}

    def routes() -> dict:
        return {f"{k}/{r}": n for k, w in wrappers.items() for r, n in w.launches_by_route.items()}

    before = routes()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qm.forward(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_summary(prof, wall, f"alexnet forward b{BATCH}", top=16)
    print(f"[forward] kernel launches by route: "
          f"{ {k: n - before[k] for k, n in routes().items() if n != before[k]} }")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    for e in host:
        print(f"[forward host]   {e.self_cpu_time_total / 1e3:9.3f} ms self  x{e.count:<6d} "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
