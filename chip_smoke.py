#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the two CUDA kernels of the packed CNN path from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version at full-width AlexNet shapes
(batch 64) and times kernel, plain version and one library call, then
drives the main path: ``api.quantize`` (static calibration, bias fold,
ELP_BSD a4 packing) of seeded full-width AlexNet weights and
``QuantizedModel.forward`` on 64 seeded images, checking that the forward
launched the tiled kernel 5 times and the decode-step kernel 3 times and
that its logits match the same packed model run on the CPU.

    python3 chip_smoke.py

Exits non-zero on any failure, and without a result when there is no
CUDA device. The last line is the JSON device record; the line before it
holds the card's name and power limit, and before that one JSON object
with each kernel's numbers.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 outside the
# tensor cores and device memory bandwidth.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
BATCH = 64
REL_TOL = 2e-5  # kernel vs plain: float32 sums over K <= 12544 in another order
# Card vs CPU logits, relative to max |logit|. With float activations the
# two differ only by float32 sums in another order. With static 8-bit
# activations a pre-activation that lies within that noise of a rounding
# half-step lands on the neighbouring level on one device and not on the
# other, and random weights carry such flips to the logits: switching only
# the accumulation to float64 on the CPU moves ALEXNET_MINI's static logits
# by 1.2 % of max |logit| and VGG_MINI's by 1.0 % (300 images each).
FLOAT_LOGIT_REL_TOL = 1e-4
STATIC_LOGIT_REL_TOL = 5e-2
L2_FLUSH_BYTES = 128 << 20  # twice the 50 MB L2: every timed launch starts cold


def timed_ms(fn, torch, flush, iters: int = 7) -> float:
    """Median device time of ``fn`` over ``iters`` launches, L2 flushed before each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> dict:
    """The least time for the work: operations at the f32 peak, bytes at the HBM rate."""
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def main() -> int:
    # One card: the run uses device 0 and its record says so.
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch import _build, api
    from repro_torch.device import full_f32
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv import extract_patches, pad_nhwc
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul, elp_bsd_matmul_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul, fused_decode_matmul_plain
    from repro_torch.models import cnn

    dev = torch.device("cuda")
    # -- phase 1: card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs exactly one visible card, got {torch.cuda.device_count()} "
              "(set CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 1
    print(f"[card] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"SMs {torch.cuda.get_device_properties(0).multi_processor_count}")

    # -- phase 2: build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build(["elp_bsd_matmul", "fused_decode"])
    print(f"[build] nvcc {time.perf_counter() - t0:.1f} s for both kernels")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- phase 3: kernels against their plain versions ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[kernels] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; tolerance max_abs_err <= "
          f"{REL_TOL:g} * max|plain|")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rows = {"elp_bsd_matmul": [], "fused_decode_matmul": []}
    failures = []

    def check(kernel, label, got, want):
        err = (got - want).abs().max().item()
        limit = REL_TOL * want.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= limit
        print(f"[kernels] {kernel} {label}: max_abs_err {err:.3e} (limit {limit:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {label}")
        return err

    under_test = {"elp_bsd_matmul": (elp_bsd_matmul, elp_bsd_matmul_plain, "tiled"),
               "fused_decode_matmul": (fused_decode_matmul, fused_decode_matmul_plain, "fused")}

    def case(name, lhs, pw, label, library=None):
        """``lhs @ pw`` on kernel ``name`` against its plain version, at the
        inputs the main path gives it; with a ``library`` call, also time
        kernel, plain and library, and bound the work at these shapes."""
        kernel, plain, impl = under_test[name]
        m, kdim, n = lhs.shape[0], lhs.shape[1], pw.shape[1]
        if pw.sf.numel() > 1:  # per-channel sf: applied by the wrapper after the kernel
            one = torch.ones(1, device=dev)
            want = plain(lhs, pw.codes, one, pw.fmt, nibble=pw.nibble) * pw.sf
            check(name, label, ops.quantized_matmul(lhs, pw, impl=impl), want)
            return
        run = lambda: kernel(lhs, pw.codes, pw.sf, pw.fmt, nibble=pw.nibble)  # noqa: E731
        ref = lambda: plain(lhs, pw.codes, pw.sf, pw.fmt, nibble=pw.nibble)  # noqa: E731
        row = {"shape": f"{label} M={m} K={kdim} N={n}"}
        row["max_abs_err"] = check(name, row["shape"], run(), ref())
        if library is None:
            return
        with full_f32():
            lib_out = library()
            print(f"[kernels] {label} library vs kernel: max_abs_diff "
                  f"{(lib_out.reshape(m, n) - run()).abs().max().item():.3e}")
            row["library_ms"] = timed_ms(library, torch, flush)
        row["ms"] = timed_ms(run, torch, flush)
        row["plain_ms"] = timed_ms(ref, torch, flush)
        # The function's own work: x, codes and sf read once, out written once.
        flops = 2.0 * m * kdim * n
        nbytes = lhs.numel() * 4 + pw.codes.numel() + 4 + m * n * 4
        row.update(bound(flops, nbytes))
        row["tflops"] = flops / row["ms"] / 1e9
        rows[name].append(row)

    # The five AlexNet convs at batch 64: (input H = W, Cin, k, stride, Cout).
    # Library: cuDNN F.conv2d on the conv input with the dequantized weight.
    convs = [(224, 3, 11, 4, 96), (28, 96, 5, 1, 256), (14, 256, 3, 1, 384),
             (14, 384, 3, 1, 384), (14, 384, 3, 1, 256)]
    for i, (hw, cin, k, stride, cout) in enumerate(convs):
        img = torch.randn(BATCH, hw, hw, cin, device=dev, generator=gen)
        w = torch.randn(k, k, cin, cout, device=dev, generator=gen) * (1.0 / k / math.sqrt(k))
        patches = extract_patches(img, k, k, stride=stride).reshape(-1, k * k * cin)
        pw, _ = ops.pack_conv_weight(w, "elp_bsd_a4")
        wq = ops.dequantize_nd(pw).permute(3, 2, 0, 1).contiguous()
        xi = pad_nhwc(img, k, k, stride, "SAME").permute(0, 3, 1, 2).contiguous()
        library = lambda: F.conv2d(xi, wq, stride=stride).permute(0, 2, 3, 1)  # noqa: E731
        case("elp_bsd_matmul", patches, pw, f"conv{i} a4/nibble", library)
        if i == 1:
            pw, _ = ops.pack_conv_weight(w, "elp_bsd_a4", granularity="per_channel")
            case("elp_bsd_matmul", patches, pw, f"conv{i} a4/nibble per-channel sf")
        if i == 2:
            case("elp_bsd_matmul", patches, ops.pack_conv_weight(w, "elp_bsd_c6")[0],
                 f"conv{i} c6/u8")

    # The three AlexNet fc layers at M = 64: (K, N). Library: torch.matmul
    # on the dequantized weight.
    fcs = [(12544, 4096), (4096, 4096), (4096, 1000)]
    for i, (kdim, n) in enumerate(fcs):
        xa = torch.relu(torch.randn(BATCH, kdim, device=dev, generator=gen))
        w = torch.randn(kdim, n, device=dev, generator=gen) / math.sqrt(kdim)
        pw, _ = ops.pack_weight(w, "elp_bsd_a4")
        wq = ops.dequantize(pw)
        library = lambda: torch.matmul(xa, wq)  # noqa: E731
        case("fused_decode_matmul", xa, pw, f"fc{i} a4/nibble", library)
        if i == 1:
            case("fused_decode_matmul", xa, ops.pack_weight(w, "elp_bsd_c6")[0], f"fc{i} c6/u8")
        if i == 2:
            pw, _ = ops.pack_weight(w, "elp_bsd_a4", granularity="per_channel")
            case("fused_decode_matmul", xa, pw, f"fc{i} a4/nibble per-channel sf")
    for name, rs in rows.items():
        for r in rs:
            print(f"[kernels] {name} {r['shape']}: kernel {r['ms']:.4f} ms "
                  f"({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    del flush

    # -- phase 4: the main path ----------------------------------------------------
    t0 = time.perf_counter()
    params = cnn.init_params(cnn.ALEXNET, seed=0)
    img_gen = torch.Generator(device=dev).manual_seed(1)
    calib = torch.randn(2, 16, 224, 224, 3, device=dev, generator=img_gen)
    batch = torch.randn(BATCH, 224, 224, 3, device=dev, generator=img_gen)
    torch.cuda.synchronize()
    print(f"[main] seeded ALEXNET params ({sum(v.numel() for v in params.values())} weights) "
          f"and images in {time.perf_counter() - t0:.1f} s")
    scheme = api.QuantScheme(fmt="elp_bsd_a4", act="static", act_bits=8)
    t0 = time.perf_counter()
    qm = api.quantize(cnn.ALEXNET, params, scheme, calib_data=calib)
    torch.cuda.synchronize()
    print(f"[main] api.quantize (calibrate 2x16 images, fold, pack): "
          f"{time.perf_counter() - t0:.2f} s; packed {qm.report.packed_bytes} B "
          f"(raw {qm.report.raw_bytes} B, {qm.report.compression:.2f}x), "
          f"Table II energy {qm.report.energy_nj:.4g} nJ")

    elp_bsd_matmul.launches = 0
    fused_decode_matmul.launches = 0
    logits = qm.forward(batch)
    torch.cuda.synchronize()
    launches = {"elp_bsd_matmul": elp_bsd_matmul.launches,
                "fused_decode_matmul": fused_decode_matmul.launches}
    print(f"[main] launches in one forward at batch {BATCH}: {launches}")
    if launches != {"elp_bsd_matmul": 5, "fused_decode_matmul": 3}:
        failures.append(f"launch counts {launches}")
    if tuple(logits.shape) != (BATCH, 1000) or not bool(torch.isfinite(logits).all()):
        failures.append(f"logits shape {tuple(logits.shape)} or non-finite values")

    fwd = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        t0 = time.perf_counter()
        qm.forward(batch)
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] forward at batch {BATCH}: median {statistics.median(fwd):.2f} ms "
          f"(runs {[round(t, 2) for t in fwd]}), max_memory_allocated {peak} B")

    t0 = time.perf_counter()
    qm_cpu = qm.to("cpu")
    four = batch[:4].cpu()
    float_card = cnn.forward(qm.params, cnn.ALEXNET, batch[:4]).cpu()
    pairs = [
        ("static 8-bit activations", logits[:4].cpu(), qm_cpu.forward(four), STATIC_LOGIT_REL_TOL),
        ("float activations", float_card, cnn.forward(qm_cpu.params, cnn.ALEXNET, four),
         FLOAT_LOGIT_REL_TOL),
    ]
    for label, card, cpu, rel in pairs:
        diff = (card - cpu).abs().max().item()
        limit = rel * cpu.abs().max().item()
        same_argmax = bool((card.argmax(-1) == cpu.argmax(-1)).all())
        print(f"[main] card vs CPU logits, {label}, same packed params, 4 images: max_abs_diff "
              f"{diff:.3e} (limit {rel:g} * max|logit| = {limit:.3e}), argmax identical "
              f"{same_argmax}")
        if not (diff <= limit and same_argmax):
            failures.append(f"card logits ({label}) differ from the CPU port")
    print(f"[main] CPU reference runs took {time.perf_counter() - t0:.1f} s")

    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1

    sources = {
        "elp_bsd_matmul": ("src/repro_torch/csrc/elp_bsd_matmul.cu",
                           "src/repro/kernels/elp_bsd_matmul.py:69"),
        "fused_decode_matmul": ("src/repro_torch/csrc/fused_decode.cu",
                                "src/repro/kernels/fused_decode.py:70"),
    }
    kernels = []
    for name, rs in rows.items():
        # one forward's worth: the sums over the main path's shapes
        ops_ms, bytes_ms = sum(r["ops_ms"] for r in rs), sum(r["bytes_ms"] for r in rs)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in rs),
        })
    print(json.dumps({"kernels": kernels}))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
