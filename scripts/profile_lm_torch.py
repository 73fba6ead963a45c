#!/usr/bin/env python3
"""Where a packed qwen3-8b prefill and decode step spend their time on one NVIDIA GPU.

Builds the port's kernels, converts seeded full-width qwen3-8b weights as
``chip_smoke.py`` does (``api.quantize``, static 8-bit activations,
calibration on [2, 4, 128] seeded token ids), then traces one prefill of
16 prompts x 128 tokens and three lockstep decode steps of the full
36-layer model with ``torch.profiler`` and prints, per phase: the
host-clock time, the summed device time of the kernels the trace
recorded, the device's idle share, the device kernels that took the most
time, the launches of each kernel route, and (decode) the host-side
operations that took the most host time.

    python3 scripts/profile_lm_torch.py

Needs a CUDA device and exits non-zero without one. A Chrome trace of the
decode window goes to ``build/profile_lm_decode.json``.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
STEPS = 3  # decode steps in the traced window


def kernel_summary(prof, wall_ms: float, label: str, top: int = 12) -> None:
    """Print the device time the trace holds, the idle share, and the top kernels."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{label}] wall {wall_ms:.2f} ms; device time not traced (not measured)")
        return
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(ms for _, ms in by_name.values())
    print(f"[{label}] wall {wall_ms:.2f} ms, device kernels {busy:.2f} ms "
          f"({len(kernels)} launches), device idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"[{label}]   {ms:9.3f} ms {100 * ms / busy:5.1f} %  x{n:<5d} {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_lm_torch: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _build, api
    from repro_torch.configs import get_config
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_decode import fused_decode_matmul
    from repro_torch.models import transformer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    _build.build(list(_build.SOURCES))
    cfg = get_config("qwen3_8b")
    dev = torch.device("cuda")
    params = transformer.init_params(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    calib = torch.randint(0, cfg.vocab, (2, 4, 128), device=dev, generator=gen)
    prompts = torch.randint(0, cfg.vocab, (16, 128), device=dev, generator=gen)
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act="static"), calib_data=calib)
    del params
    torch.cuda.empty_cache()
    p = qm.params
    cache = transformer.init_cache(cfg, 16, 128 + STEPS + 2)

    def prefill():
        return transformer.prefill(p, cfg, prompts, cache)[0]

    logits = prefill()  # warm-up
    tok = logits.argmax(-1).to(torch.int32)
    transformer.decode_step(p, cfg, tok, cache, 128)
    torch.cuda.synchronize()

    wrappers = {"elp_bsd_matmul": elp_bsd_matmul, "fused_decode_matmul": fused_decode_matmul,
                "flash_attention": flash_attention}

    def routes() -> dict:
        return {f"{k}/{r}": n for k, w in wrappers.items() for r, n in w.launches_by_route.items()}

    def launched(before: dict) -> dict:
        return {k: n - before[k] for k, n in routes().items() if n != before[k]}

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    before = routes()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_summary(prof, wall, f"prefill b16 s128, {cfg.n_layers} layers")
    print(f"[prefill] kernel launches by route: {launched(before)}")

    tok = logits.argmax(-1).to(torch.int32)
    before = routes()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            logits, _ = transformer.decode_step(p, cfg, tok, cache, 128 + i)
            tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_summary(prof, wall, f"decode x{STEPS} b16, {cfg.n_layers} layers")
    print(f"[decode] kernel launches by route over {STEPS} steps: {launched(before)}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    for e in host:
        print(f"[decode host]   {e.self_cpu_time_total / 1e3:9.3f} ms self  x{e.count:<6d} "
              f"{e.key[:90]}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "build", "profile_lm_decode.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
