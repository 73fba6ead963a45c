#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the six CUDA kernel sources from ``src/repro_torch/csrc`` (one
``nvcc`` each, in parallel) and drives the port's two main paths. The two
packed matmuls have three routes each, flash attention two, picked by the
wrapper's ``route``: ``<kernel>/wgmma`` (bf16 on the tensor cores; the LM's
bf16 activations), ``<matmul>/bf16x3`` (float32 activations split exactly
into three bf16 terms on the tensor cores; AlexNet) and ``<kernel>/f32``
(float32 on CUDA cores; on no main path now, launched directly here so it
stays held and timed).

* the packed CNN path: each matmul's bf16x3 route held against its plain
  PyTorch version at full-width AlexNet shapes (batch 64), and the float32
  CUDA-core kernel it replaced launched directly on the same inputs, both
  timed beside the plain version and one library call; controls that the
  limit sees a product of one bf16 term of x (and a report of two); then
  ``api.quantize`` (static calibration, bias fold, ELP_BSD a4 packing) of
  seeded full-width AlexNet weights and ``QuantizedModel.forward`` on 64
  seeded images, checking 5 tiled + 3 decode-step launches, all on the
  bf16x3 routes, and the logits against the same packed model run on the
  CPU;
* the packed LM serving path at full-width qwen3-8b: the flash-attention
  kernels held against their plain version (f32 route on float32 inputs,
  wgmma route on bf16, causal and not, at the prefill shape
  [16, 32, 128, 128] and at [1, 32, 4096, 128]) and the matmul kernels at
  the LM's shapes (M = 2048 prefill on the tiled wgmma route, plus one
  ragged shape and one c6 u8 shape there; M = 16 decode step on the
  decode-step wgmma route), each timed beside its plain version, one
  library call and, for the wgmma routes, the f32 route on the same
  inputs (the kernel the route replaced on the LM path); then
  ``api.quantize`` (calibration on [2, 4, 128] seeded token ids, per-slice
  a4 packing of every block matmul) of seeded bf16 qwen3-8b weights and
  ``QuantizedModel.generate`` of 16 new tokens for 16 seeded 128-token
  prompts, checking 252 tiled + 36 flash launches in the prefill and 252
  decode-step launches per decode step, all on the wgmma routes (0 on the
  float32 routes); the generated tokens teacher-forced
  through the same packed model with every kernel swapped for its plain
  version, logits compared, beside controls of that comparison (correct
  changes of rounding and planted faults) and the same reading with float
  activations; and the reduced 2-layer qwen3-8b on the card against the CPU.

    python3 chip_smoke.py

Exits non-zero on any failure, and without a result when there is no
CUDA device. The last line is the JSON device record; the line before it
holds the card's name and power limit, and before that one JSON object
with each kernel route's numbers: ``launches`` counts its launches on both
main paths (one AlexNet forward, one generate), and ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` are the per-shape times of those launches,
each shape weighted by its launches. The three ``/f32`` routes have no
launch on either path: the matmuls' times are those of AlexNet's shapes
(one forward's worth, the kernel launched directly), flash's those of the
prefill's attention shape in float32, weighted as one generate's 36
launches. Every time is the device's: a launch is queued behind a device
sleep, so the host's own time to issue it is not counted.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): operations by operand
# type (float32 outside the tensor cores, bfloat16 on them) and device memory
# bandwidth. A kernel's bound takes the rate of its arithmetic: its inputs'
# type, or for the bf16x3 routes three bf16 passes over the product.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "bf16x3": 989e12 / 3}
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
SLEEP_CYCLES = 2_000_000  # about 1 ms: longer than the host takes to issue any timed call
# Flash attention, kernel vs plain, elementwise: |got - want| <= rel * |want|
# + abs_rel * max |want|. float32: sums in another order (2e-5 of max |out|).
# bfloat16: each rounds its float32 result once, so one bf16 step may
# separate them (at most 2^-7 of the value, exactly that at a power of two,
# so such a step reads just under the limit), on top of five times that
# float32 noise for the results before rounding.
FLASH_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}
# The LM path's kernels held against their plain versions (same packed
# model, same tokens), relative to max |logit|, with static 8-bit and with
# float activations. Through 36 layers of random weights a correct change
# of float32 rounding reads at full scale: every kernel's function summed in
# float64 reads 3.7e-2 (static) and 2.0e-2 (float) against the plain
# versions, about what the kernels read. Planted faults read 0.38 (the
# decode-step matmul skipping its last 128 K rows) and 0.65 (each query
# seeing the next key). The limit sits between; faults within the noise
# (P.V accumulated in bf16 reads 4.9e-2) are for the elementwise flash check.
LM_LOGIT_REL_TOL = 5e-2
LM_FLOAT_LOGIT_REL_TOL = 5e-2
LM_BATCH, LM_PROMPT, LM_NEW = 16, 128, 16


def timed_ms(fn, torch, flush, iters: int = 7) -> float:
    """Median device time of ``fn`` over ``iters`` launches, L2 flushed before each.

    A device sleep ahead of the start event keeps the device busy while the
    host issues ``fn``, so the time is the device's work alone.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time for the work: operations at the peak of ``dtype`` inputs (a
    torch dtype, or ``"bf16x3"``), bytes at HBM."""
    rate = PEAK_FLOPS[dtype if isinstance(dtype, str) else str(dtype)[6:]]
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _flash_bound(q, k, causal: bool) -> dict:
    """Operations (4*hd per unmasked query-key pair) at q's type's peak, q/k/v/out bytes at HBM."""
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    pairs = b * h * (sq * (sq + 1) / 2 if causal else sq * sk)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bound(4.0 * hd * pairs, nbytes, q.dtype)


def _worst(got, want, tol) -> float:
    """Largest |got - want| / (rel * |want| + abs_rel * max |want|), tol = (rel, abs_rel)."""
    want = want.float()
    limit = tol[0] * want.abs() + tol[1] * want.abs().max()
    return ((got.float() - want).abs() / limit).max().item()


def lm_kernel_phase(torch, dev, gen, flush, rows, failures) -> None:
    """Each kernel of the LM path against its plain version at the path's shapes, timed
    beside it and one library call; rows carry each shape's launches per generate."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.elp_bsd import resolve_format
    from repro_torch.device import full_f32
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels.elp_bsd_matmul import (
        elp_bsd_matmul,
        elp_bsd_matmul_plain,
        launch_checked,
        route,
    )
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul, fused_decode_matmul_plain
    from repro_torch.runtime.quantized_params import quantize_stacked

    cfg = get_config("qwen3_8b")
    n_layers, steps = cfg.n_layers, LM_NEW - 1

    def record(name, row, got, want, tol):
        err, worst = (got.float() - want.float()).abs().max().item(), _worst(got, want, tol)
        ok = bool(torch.isfinite(got.float()).all()) and worst <= 1.0
        print(f"[lm-kernels] {name} {row['shape']}: max_abs_err {err:.3e}, worst |err| / limit "
              f"{worst:.3f} (limit {tol[0]:g} * |plain| + {tol[1]:g} * max|plain|) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {row['shape']}")
        row["max_abs_err"] = err

    # Flash attention: the issue's two shapes with H = KVH (the JAX kernel's
    # contract), float32 on the f32 route and bf16 on the wgmma route, then
    # the main path's own call (strided q, GQA k/v). The f32 route's prefill
    # shape stands for the 36 launches a generate would make in float32.
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s in ((LM_BATCH, LM_PROMPT), (1, 4096)):
            q, k, v = (torch.randn(b, 32, s, 128, device=dev, generator=gen).to(dtype)
                       for _ in range(3))
            for causal in (True, False):
                stand_in = dtype == torch.float32 and s == LM_PROMPT and causal
                cases.append((f"{str(dtype)[6:]} [{b}, 32, {s}, 128] causal={causal}",
                              q, k, v, causal, n_layers if stand_in else 0))
    qm = torch.randn(LM_BATCH, LM_PROMPT, 32, 128, device=dev, generator=gen).to(torch.bfloat16)
    km, vm = (torch.randn(LM_BATCH, LM_PROMPT, 8, 128, device=dev, generator=gen)
              .to(torch.bfloat16) for _ in range(2))
    cases.append(("main path: bfloat16 q[16, 32, 128, 128] strided, GQA k/v[16, 8, 128, 128], "
                  "causal", qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2), True,
                  n_layers))
    for label, q, k, v, causal, weight in cases:
        name = f"flash_attention/{fa.route(q, k, v)}"
        run = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        ref = lambda: flash_attention_plain(q, k, v, causal=causal)  # noqa: E731
        gqa = k.shape[1] != q.shape[1]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=gqa)
        row = {"shape": label, "weight": weight, "lm": True}
        before = dict(flash_attention.launches_by_route)
        record(name, row, run(), ref(), FLASH_TOL[str(q.dtype)[6:]])
        if flash_attention.launches_by_route[name[16:]] != before[name[16:]] + 1:
            failures.append(f"{name} {label}: not launched on its route")
        with full_f32():
            row["library_ms"] = timed_ms(library, torch, flush)
        row["ms"] = timed_ms(run, torch, flush)
        row["plain_ms"] = timed_ms(ref, torch, flush)
        if name.endswith("wgmma"):
            # the kernel this route replaced, on the same bf16 inputs
            out = torch.empty_like(q)
            row["f32_route_ms"] = timed_ms(
                lambda: fa._launch("f32", q, k, v, out, q.shape[1] // k.shape[1], causal, 0),
                torch, flush)
        row.update(_flash_bound(q, k, causal))
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        rows[name].append(row)
    # The elementwise limit must see a subtle fault that the logits cannot:
    # P.V accumulated in bf16, at the main path's call. Beside it, what the
    # wgmma kernel would read with P rounded once to bf16 (it adds P_hi.V and
    # P_lo.V instead): a control that is reported, not gated.
    _, q, k, v, causal, _ = cases[-1]
    want = flash_attention_plain(q, k, v, causal=causal)
    worst = _worst(_flash_bf16_acc(q, k, v, causal=causal), want, FLASH_TOL["bfloat16"])
    print(f"[lm-kernels] control: flash with P.V accumulated in bf16 against the plain "
          f"version, main path call: worst |err| / limit {worst:.3f} (must exceed 1)")
    if worst <= 1.0:
        failures.append("the elementwise flash limit does not see P.V accumulated in bf16")
    single = _worst(_flash_bf16_p(q, k, v, causal=causal), want, FLASH_TOL["bfloat16"])
    print(f"[lm-kernels] control: flash with a single bf16 P (P.V from bf16(P), float32 sums) "
          f"against the plain version, main path call: worst |err| / limit {single:.3f} "
          f"(reported; the wgmma kernel splits P into two bf16 halves)")

    # The packed matmuls: each block matmul shape of qwen3-8b, a4 nibble codes
    # of one per-slice layer view, bf16 activations as the main path gives
    # them, at M = 2048 (prefill, tiled kernel, wgmma route) and M = 16
    # (decode step). The decoded weights are exact in bf16, so the inputs are
    # bf16 and one bf16 torch.matmul (float32 accumulation) on the
    # dequantized weight is the library yardstick. The wgmma route also runs
    # at a ragged shape (odd K and N off TMA's 16-byte rows: padded copies)
    # and on c6 u8 codes, which the main path does not launch. Each wgmma
    # case prints its distance from the product summed in float64 beside
    # its distance from the plain version.
    fmt = resolve_format("elp4")
    shapes = [("wq/wo", 4096, 4096, 2, fmt), ("wk/wv", 4096, 1024, 2, fmt),
              ("w1/w3", 4096, 12288, 2, fmt), ("w2", 12288, 4096, 1, fmt),
              ("ragged", 4001, 1000, 0, fmt), ("c6 u8 wq/wo", 4096, 4096, 0, resolve_format("elp8"))]
    for label, kdim, n, per_layer, f in shapes:
        w = (torch.randn(1, kdim, n, device=dev, generator=gen) / math.sqrt(kdim)).to(torch.bfloat16)
        pw = quantize_stacked(w, f).layer(0)
        wq = ops.dequantize(pw).to(torch.bfloat16)
        del w
        cases = [("elp_bsd_matmul/wgmma", elp_bsd_matmul, elp_bsd_matmul_plain,
                  1999 if label == "ragged" else LM_BATCH * LM_PROMPT, n_layers * per_layer)]
        if f is fmt and per_layer:
            cases.append(("fused_decode_matmul/wgmma", fused_decode_matmul,
                          fused_decode_matmul_plain, LM_BATCH, steps * n_layers * per_layer))
        for name, kernel, plain, m, weight in cases:
            x = torch.randn(m, kdim, device=dev, generator=gen).to(torch.bfloat16)
            # float32 out, as quantized_matmul asks of the kernels
            run = lambda: kernel(x, pw.codes, pw.sf, f, nibble=pw.nibble,  # noqa: E731
                                 out_dtype=torch.float32)
            ref = lambda: plain(x, pw.codes, pw.sf, f, nibble=pw.nibble,  # noqa: E731
                                out_dtype=torch.float32)
            library = lambda: torch.matmul(x, wq)  # noqa: E731
            row = {"shape": f"{label} M={m} K={kdim} N={n}", "weight": weight, "lm": True}
            if route(x, f) != "wgmma":
                failures.append(f"{name} {row['shape']} routed to {route(x, f)}")
            got = run()
            record(name, row, got, ref(), (0.0, REL_TOL))
            if kernel is elp_bsd_matmul:
                exact = _f64_sum(x, pw.codes, pw.sf, f, nibble=pw.nibble, out_dtype=torch.float32)
                print(f"[lm-kernels] {name} {row['shape']}: max |kernel - float64 sum| "
                      f"{(got - exact).abs().max().item():.3e}, max |plain - float64 sum| "
                      f"{(ref() - exact).abs().max().item():.3e}")
                del exact
            row["library_ms"] = timed_ms(library, torch, flush)
            row["ms"] = timed_ms(run, torch, flush)
            row["plain_ms"] = timed_ms(ref, torch, flush)
            if kernel is fused_decode_matmul:
                # the kernel this route replaced, on the same bf16 x (cast to float32)
                row["f32_route_ms"] = timed_ms(
                    lambda: launch_checked("fused_decode", x, pw.codes, pw.sf, f, pw.nibble),
                    torch, flush)
            row.update(bound(2.0 * m * kdim * n, x.numel() * 2 + pw.codes.numel() + 4 + m * n * 4,
                             x.dtype))
            row["tflops"] = row["flops"] / row["ms"] / 1e9
            rows[name].append(row)
    for name in ("flash_attention/f32", "flash_attention/wgmma", "elp_bsd_matmul/wgmma",
                 "fused_decode_matmul/wgmma"):
        for r in rows[name]:
            if r.get("lm"):
                f32 = f", f32 route {r['f32_route_ms']:.4f} ms" if "f32_route_ms" in r else ""
                print(f"[lm-kernels] {name} {r['shape']}: kernel {r['ms']:.4f} ms "
                      f"({r['tflops']:.1f} TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of bound), "
                      f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}){f32}; {r['weight']} launches "
                      "per generate")
    for name in ("flash_attention/wgmma", "fused_decode_matmul/wgmma"):
        rs = [r for r in rows[name] if r.get("weight") and "f32_route_ms" in r]
        new, old = (sum(r["weight"] * r[k] for r in rs) for k in ("ms", "f32_route_ms"))
        print(f"[lm-kernels] {name} per generate: {new:.3f} ms; the f32 route it replaced on the "
              f"same inputs {old:.3f} ms ({old / new:.2f}x)")


# The eight kernel routes, in the order of _counts().
KERNEL_ROUTES = ("elp_bsd_matmul/wgmma", "elp_bsd_matmul/bf16x3", "elp_bsd_matmul/f32",
                 "fused_decode_matmul/wgmma", "fused_decode_matmul/bf16x3",
                 "fused_decode_matmul/f32", "flash_attention/wgmma", "flash_attention/f32")


def _wrappers():
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_decode import fused_decode_matmul

    return {"elp_bsd_matmul": elp_bsd_matmul, "fused_decode_matmul": fused_decode_matmul,
            "flash_attention": flash_attention}


def _counts() -> tuple:
    """Launches so far, per route of KERNEL_ROUTES."""
    w = _wrappers()
    return tuple(w[k.split("/")[0]].launches_by_route[k.split("/")[1]] for k in KERNEL_ROUTES)


def _expected(launches: dict) -> tuple:
    """A _counts() tuple: ``launches`` by route, 0 on every other route."""
    assert set(launches) <= set(KERNEL_ROUTES), launches
    return tuple(launches.get(k, 0) for k in KERNEL_ROUTES)


def _zero_counts() -> None:
    for k in _wrappers().values():
        k.launches = 0
        for r in k.launches_by_route:
            k.launches_by_route[r] = 0


def _teacher_forced(torch, transformer, params, cfg, prompts, tokens, cache) -> list:
    """Logits of the prefill and of each decode step fed ``tokens[:, i]``."""
    logits, cache = transformer.prefill(params, cfg, prompts, cache)
    out = [logits]
    for i in range(tokens.shape[1] - 1):
        logits, cache = transformer.decode_step(params, cfg, tokens[:, i:i + 1], cache,
                                                prompts.shape[1] + i)
        out.append(logits)
    return out


def _rel(got: list, want: list) -> float:
    """Largest max |got - want| / max |want| over the positions."""
    return max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, want))


def _plain_flash(shift: int = 0):
    """The plain flash version under the kernel's signature; ``shift`` > 0 plants a
    fault: each query also sees the ``shift`` keys after it."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    def flash(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset + shift)
    return flash


def _flash_probs(q, k, q_offset: int, causal: bool, dtype):
    """Unnormalised softmax numerators in ``dtype``, as the plain version forms them."""
    import torch

    group = q.shape[1] // k.shape[1]
    logits = (q.to(dtype) * (1.0 / math.sqrt(q.shape[3]))) @ (
        k.to(dtype).repeat_interleave(group, dim=1).transpose(-1, -2))
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)
        logits = logits.masked_fill(qpos[:, None] < torch.arange(k.shape[2], device=q.device),
                                    -1e30)
    return torch.exp(logits - logits.amax(-1, keepdim=True))


def _flash_f64(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
    """Attention summed in float64 and rounded once to q's type: a correct result."""
    import torch

    p = _flash_probs(q, k, q_offset, causal, torch.float64)
    vd = v.double().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return ((p @ vd) / p.sum(-1, keepdim=True)).to(q.dtype)


def _flash_bf16_p(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
    """A control: P rounded once to bfloat16 before P.V (float32 sums, float32 l)."""
    import torch

    p = _flash_probs(q, k, q_offset, causal, torch.float32)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return ((p.to(torch.bfloat16).float() @ vf) / p.sum(-1, keepdim=True)).to(q.dtype)


def _flash_bf16_acc(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
    """A planted fault: P·V accumulated in bfloat16, one key at a time."""
    import torch

    p = _flash_probs(q, k, q_offset, causal, torch.float32)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    acc = torch.zeros(*p.shape[:3], vf.shape[3], dtype=torch.bfloat16, device=q.device)
    for j in range(k.shape[2]):
        acc = (acc.float() + p[..., j:j + 1] * vf[:, :, j:j + 1]).to(torch.bfloat16)
    return (acc.float() / p.sum(-1, keepdim=True)).to(q.dtype)


def _f64_sum(x, codes, sf, fmt, *, nibble=False, out_dtype=None):
    """The plain product summed in float64 and rounded once: a correct result."""
    import torch

    from repro_torch.kernels.ref import decode_values_shift_add, unpack_nibbles_k

    w = decode_values_shift_add(unpack_nibbles_k(codes) if nibble else codes, fmt)
    out = torch.matmul(x.double(), w[: x.shape[1]].double()) * sf.double().reshape(())
    return out.float().to(out_dtype or x.dtype)


def _bf16_step(fn, gen):
    """``fn`` with each element of its output moved one bfloat16 step up or down at random."""
    import torch

    def moved(*args, **kwargs):
        y = fn(*args, **kwargs)
        yf = y.float()
        _, e = torch.frexp(yf)  # 2^(e-1) <= |y| < 2^e: one bf16 step is 2^(e-8)
        sign = torch.randint(0, 2, y.shape, device=y.device, generator=gen) * 2 - 1
        return (yf + torch.ldexp(sign.float(), e - 8) * (yf != 0)).to(y.dtype)
    return moved


def _skip_k_tail(x, codes, sf, fmt, *, nibble=False, out_dtype=None):
    """A planted fault: the plain decode-step product without its last 128 K rows."""
    from repro_torch.kernels.fused_decode import fused_decode_matmul_plain

    k = x.shape[1] - 128
    return fused_decode_matmul_plain(x[:, :k], codes[:k // 2 if nibble else k], sf, fmt,
                                     nibble=nibble, out_dtype=out_dtype)


def lm_main_path(torch, dev, failures) -> dict:
    """Full-width qwen3-8b: seeded params, api.quantize, QuantizedModel.generate;
    then the same packed model with each kernel swapped for its plain version."""
    import repro_torch.kernels.ops as ops_mod
    import repro_torch.models.transformer as transformer
    import repro_torch.serve.engine as engine_mod
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul_plain
    from repro_torch.runtime.quantized_params import QUANTIZABLE

    cfg = get_config("qwen3_8b")
    n_layers = cfg.n_layers
    per_layer = 7  # wq, wk, wv, wo, w1, w3, w2
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    calib = torch.randint(0, cfg.vocab, (2, 4, LM_PROMPT), device=dev, generator=gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device=dev, generator=gen)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for k, v in params.items() if k != "blocks")
    n_par += sum(v.numel() for v in params["blocks"].values())
    bf16_bytes = sum(v.numel() * v.element_size() for k, v in params["blocks"].items()
                     if k in QUANTIZABLE)
    print(f"[lm] seeded qwen3-8b params ({n_par} weights, {cfg.dtype}) on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act="static"), calib_data=calib)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    del params  # the float block weights go; embed, norms and lm_head live on in qm.params
    torch.cuda.empty_cache()
    rep = qm.report
    print(f"[lm] conversion s {conv_s:.2f} (api.quantize: calibrate on 2x4x{LM_PROMPT} tokens, "
          f"pack {n_layers * per_layer} layer slices); block matmul code + sf bytes "
          f"{rep.packed_weight_bytes} against {bf16_bytes} bf16 bytes of the same leaves "
          f"({bf16_bytes / rep.packed_weight_bytes:.2f}x); memory_allocated after dropping the "
          f"float blocks {torch.cuda.memory_allocated()} B")

    # The main path, counted from zero, with each prefill and decode step of
    # static_generate counted on its own (the model API it calls is wrapped
    # here, in this script only).
    phases = []

    def counting_get_model(cfg_):
        inner = real_get_model(cfg_)

        def wrap(fn, label):
            def call(*args, **kwargs):
                before = _counts()
                out = fn(*args, **kwargs)
                phases.append((label, tuple(a - b for a, b in zip(_counts(), before))))
                return out
            return call

        return dataclasses.replace(inner, prefill=wrap(inner.prefill, "prefill"),
                                   decode_step=wrap(inner.decode_step, "decode"))

    real_get_model = engine_mod.get_model
    engine_mod.get_model = counting_get_model
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        t0 = time.perf_counter()
        new = qm.generate(prompts, LM_NEW)
        torch.cuda.synchronize()
        gen_first_s = time.perf_counter() - t0
    finally:
        engine_mod.get_model = real_get_model
    c = _counts()
    prefill_counts = _expected({"elp_bsd_matmul/wgmma": n_layers * per_layer,
                                "flash_attention/wgmma": n_layers})
    step_counts = _expected({"fused_decode_matmul/wgmma": n_layers * per_layer})
    want_phases = [("prefill", prefill_counts)] + [("decode", step_counts)] * (LM_NEW - 1)
    print(f"[lm] launches {KERNEL_ROUTES} by phase of the generate: prefill "
          f"{phases[0][1] if phases else None}, decode steps "
          f"{sorted(set(p_[1] for p_ in phases[1:]))} over {len(phases) - 1} steps")
    if phases != want_phases:
        failures.append(f"LM launch counts by phase {phases}")
    launches = dict(zip(KERNEL_ROUTES, c))
    want = tuple(a + (LM_NEW - 1) * b for a, b in zip(prefill_counts, step_counts))
    print(f"[lm] launches in one generate ({LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_NEW} new "
          f"tokens): {launches} (expected {want})")
    if c != want:
        failures.append(f"LM launch counts {launches}")
    if (tuple(new.shape) != (LM_BATCH, LM_NEW) or int(new.min()) < 0
            or int(new.max()) >= cfg.vocab):
        failures.append(f"generated tokens of shape {tuple(new.shape)} or out of the vocab")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = qm.generate(prompts, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(again, new):
        failures.append("a second generate gave other tokens")
    print(f"[lm] generate: first {gen_first_s * 1e3:.1f} ms, second {gen_s * 1e3:.1f} ms; "
          f"tokens/s {LM_BATCH * LM_NEW / gen_s:.1f} (second run); max_memory_allocated "
          f"{peak} B (first generate)")

    # Per phase: the prefill and each decode step through the model API, counted and timed.
    p = qm.params
    cache = transformer.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW)
    pre_ms, step_ms, kernel_logits = [], [], None
    for run in range(3):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(p, cfg, prompts, cache)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        if _counts() != prefill_counts:
            failures.append(f"prefill launch counts {_counts()}")
        outs, toks, times = [logits], [logits.argmax(-1).to(torch.int32)], []
        for i in range(LM_NEW - 1):
            _zero_counts()
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(p, cfg, toks[-1], cache, LM_PROMPT + i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if _counts() != step_counts:
                failures.append(f"decode step {i} launch counts {_counts()}")
            outs.append(logits)
            toks.append(logits.argmax(-1).to(torch.int32))
        step_ms.append(times)
        if not torch.equal(torch.cat(toks, 1), new):
            failures.append(f"prefill/decode run {run} tokens differ from generate's")
        if run == 0:
            kernel_logits = outs
    later_steps = [t for times in step_ms for t in times][1:]
    print(f"[lm] prefill ms at b{LM_BATCH} s{LM_PROMPT}: first {pre_ms[0]:.2f}, median of the "
          f"later {statistics.median(pre_ms[1:]):.2f} (runs {[round(t, 2) for t in pre_ms]})")
    print(f"[lm] decode ms/step at b{LM_BATCH}: first {step_ms[0][0]:.3f}, median of the later "
          f"{statistics.median(later_steps):.3f} (min {min(later_steps):.3f}, max "
          f"{max(later_steps):.3f}, {len(later_steps)} steps)")

    # Held on the card: the same packed model and tokens with every kernel
    # rebound to its plain version (here only; the package has no switch).
    plain_mm = (elp_bsd_matmul_plain, fused_decode_matmul_plain)

    def forced(params, mm, flash) -> list:
        saved = (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul, transformer.flash_attention)
        (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul), transformer.flash_attention = mm, flash
        try:
            return _teacher_forced(torch, transformer, params, cfg, prompts, new, cache)
        finally:
            ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul, transformer.flash_attention = saved

    _zero_counts()
    t0 = time.perf_counter()
    plain_logits = forced(p, plain_mm, _plain_flash())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if any(_counts()):
        failures.append(f"the plain run launched kernels {_counts()}")
    rels, checked, agree = [], 0, 0
    for j, (kl, pl) in enumerate(zip(kernel_logits, plain_logits)):
        scale = pl.abs().max().item()
        rels.append((kl - pl).abs().max().item() / scale)
        top2 = pl[:, -1].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LM_LOGIT_REL_TOL * scale
        same = new[:, j] == pl[:, -1].argmax(-1)
        checked += int(clear.sum())
        agree += int((same & clear).sum())
        if not bool(same[clear].all()):
            failures.append(f"greedy token {j} differs from the plain argmax where its gap is clear")
    all_same = sum(int((new[:, j] == pl[:, -1].argmax(-1)).sum())
                   for j, pl in enumerate(plain_logits))
    print(f"[lm] kernels vs plain versions, teacher-forced on the generated tokens "
          f"({plain_s:.1f} s plain): max |logit diff| / max |logit| per position "
          f"{[f'{r:.2e}' for r in rels]} (limit {LM_LOGIT_REL_TOL:g}); greedy = plain argmax at "
          f"{all_same}/{LM_BATCH * LM_NEW} positions, {agree}/{checked} where the plain top-2 "
          f"gap exceeds the limit")
    if max(rels) > LM_LOGIT_REL_TOL:
        failures.append(f"LM logits: kernels vs plain {max(rels):.3e} relative")

    # Controls of that gate, each against the plain run: correct changes of
    # rounding (its noise; moving every output a whole bf16 step is more than
    # a correct kernel does), a subtle fault inside that noise, and gross
    # faults of the kind a wrong kernel makes, which must read above the limit.
    step_gen = torch.Generator(device=dev).manual_seed(4)
    controls = [
        ("noise", "every kernel's function summed in float64, rounded once",
         (_f64_sum,) * 2, _flash_f64),
        ("noise", "every flash output moved one bf16 step up or down", plain_mm,
         _bf16_step(_plain_flash(), step_gen)),
        ("noise", "every matmul output moved one bf16 step up or down",
         tuple(_bf16_step(f, step_gen) for f in plain_mm), _plain_flash()),
        ("subtle fault", "flash accumulates P.V in bf16", plain_mm, _flash_bf16_acc),
        ("fault", "flash lets each query see the next key", plain_mm, _plain_flash(shift=1)),
        ("fault", "the decode-step matmul skips its last 128 K rows",
         (elp_bsd_matmul_plain, _skip_k_tail), _plain_flash()),
    ]
    for kind, label, mm, flash in controls:
        r = _rel(forced(p, mm, flash), plain_logits)
        print(f"[lm-control] static act, {kind}: {label}: {r:.3e} of max |logit| "
              f"(limit {LM_LOGIT_REL_TOL:g})")
        if kind == "fault" and r <= LM_LOGIT_REL_TOL:
            failures.append(f"the LM logit gate does not see the planted fault: {label}")
    del qm, p, kernel_logits, plain_logits
    torch.cuda.empty_cache()

    # The same reading with float activations, where no 8-bit rounding
    # step amplifies the float32 and bf16 rounding differences.
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0)
    qf = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act="float"))
    del params
    torch.cuda.empty_cache()
    pf = qf.params
    kernels_f = forced(pf, (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul),
                       transformer.flash_attention)
    plain_f = forced(pf, plain_mm, _plain_flash())
    noise_f = forced(pf, (_f64_sum,) * 2, _flash_f64)
    rel_f, noise_rel_f = _rel(kernels_f, plain_f), _rel(noise_f, plain_f)
    print(f"[lm-control] float act ({time.perf_counter() - t0:.1f} s): kernels vs plain "
          f"{rel_f:.3e} of max |logit| (limit {LM_FLOAT_LOGIT_REL_TOL:g}); noise, every "
          f"kernel's function summed in float64, {noise_rel_f:.3e}")
    if rel_f > LM_FLOAT_LOGIT_REL_TOL:
        failures.append(f"LM logits, float act: kernels vs plain {rel_f:.3e} relative")
    del qf, pf, cache, kernels_f, plain_f, noise_f
    torch.cuda.empty_cache()
    return launches


def lm_card_vs_cpu(torch, dev, failures) -> None:
    """Reduced qwen3-8b (2 layers), packed once on the CPU: card against CPU."""
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("qwen3_8b").reduced()
    params = transformer.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(3)
    calib = torch.randint(0, cfg.vocab, (2, 4, 32), generator=g)
    prompts = torch.randint(0, cfg.vocab, (4, 80), generator=g)  # prefill M = 320: tiled
    for act, rel in (("float", FLOAT_LOGIT_REL_TOL), ("static", STATIC_LOGIT_REL_TOL)):
        qc = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act=act),
                          calib_data=calib if act == "static" else None, device="cpu")
        qg = qc.to(dev)
        tc = qc.generate(prompts, 8)
        tg = qg.generate(prompts.to(dev), 8).cpu()
        lc = _teacher_forced(torch, transformer, qc.params, cfg, prompts, tc,
                             transformer.init_cache(cfg, 4, 88, device="cpu"))
        lg = _teacher_forced(torch, transformer, qg.params, cfg, prompts.to(dev), tc.to(dev),
                             transformer.init_cache(cfg, 4, 88, device=dev))
        diff = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(lg, lc))
        same = bool(torch.equal(tc, tg))
        print(f"[lm-small] {cfg.name} act={act}: card vs CPU logits (prefill + 7 steps) max "
              f"{diff:.3e} of max |logit| (limit {rel:g}); greedy tokens identical {same}")
        if diff > rel or (act == "float" and not same):
            failures.append(f"reduced LM card vs CPU, act={act}")


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
    from repro_torch.kernels.elp_bsd_matmul import (
        elp_bsd_matmul,
        elp_bsd_matmul_plain,
        launch_checked,
        route,
    )
    from repro_torch.kernels.fused_decode import fused_decode_matmul, fused_decode_matmul_plain
    from repro_torch.kernels.ref import elp_bsd_matmul_bf16x3 as bf16x3_product
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
    reports = _build.build(list(_build.SOURCES))
    print(f"[build] nvcc {time.perf_counter() - t0:.1f} s for the {len(reports)} kernel sources "
          "(in parallel)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("registers" in line or "spill" in line or "Performance Loss" in line
                    or "arning" in line):
                print(f"[build] {name}: {line.strip()}")

    # -- phase 3: kernels against their plain versions ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[kernels] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; tolerance max_abs_err <= "
          f"{REL_TOL:g} * max|plain|")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rows = {k: [] for k in KERNEL_ROUTES}
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

    # The main path's route of each matmul, its wrapper, plain version and
    # impl, and the float32 CUDA-core kernel it replaced (launched directly).
    under_test = {"elp_bsd_matmul/bf16x3": (elp_bsd_matmul, elp_bsd_matmul_plain, "tiled",
                                            "elp_bsd_matmul"),
                  "fused_decode_matmul/bf16x3": (fused_decode_matmul, fused_decode_matmul_plain,
                                                 "fused", "fused_decode")}
    controls = []

    def case(name, lhs, pw, label, library=None):
        """``lhs @ pw`` on route ``name`` and on the float32 kernel it replaced,
        each against the plain version, at the inputs the main path gives it;
        with a ``library`` call, also time both, plain and library, and bound
        the work at these shapes at each route's arithmetic."""
        kernel, plain, impl, f32_source = under_test[name]
        f32_name = name.replace("bf16x3", "f32")
        wrapper, route_name = name.split("/")
        m, kdim, n = lhs.shape[0], lhs.shape[1], pw.shape[1]
        if route(lhs, pw.fmt) != route_name:
            failures.append(f"{name} {label}: routed to {route(lhs, pw.fmt)}")
        before = dict(kernel.launches_by_route)
        if pw.sf.numel() > 1:  # per-channel sf: applied by the wrapper after the kernel
            one = torch.ones(1, device=dev)
            want = plain(lhs, pw.codes, one, pw.fmt, nibble=pw.nibble) * pw.sf
            check(name, label, ops.quantized_matmul(lhs, pw, impl=impl), want)
            got_f32 = launch_checked(f32_source, lhs, pw.codes, one, pw.fmt, pw.nibble) * pw.sf
            check(f32_name, label + " (launched directly)", got_f32, want)
            if kernel.launches_by_route != {**before, route_name: before[route_name] + 1}:
                failures.append(f"{name} {label}: launches by route {kernel.launches_by_route}")
            return
        run = lambda: kernel(lhs, pw.codes, pw.sf, pw.fmt, nibble=pw.nibble)  # noqa: E731
        ref = lambda: plain(lhs, pw.codes, pw.sf, pw.fmt, nibble=pw.nibble)  # noqa: E731
        f32 = lambda: launch_checked(f32_source, lhs, pw.codes, pw.sf, pw.fmt,  # noqa: E731
                                     pw.nibble)
        row = {"shape": f"{label} M={m} K={kdim} N={n}"}
        want = ref()
        row["max_abs_err"] = check(name, row["shape"], run(), want)
        if kernel.launches_by_route != {**before, route_name: before[route_name] + 1}:
            failures.append(f"{name} {label}: launches by route {kernel.launches_by_route}")
        f32_row = {"shape": row["shape"],
                   "max_abs_err": check(f32_name, row["shape"] + " (launched directly)", f32(),
                                        want)}
        # Controls: the same product from fewer bf16 terms of x.
        limit = REL_TOL * want.abs().max().item()
        ratios = [(bf16x3_product(lhs, pw.codes, pw.sf, pw.fmt, nibble=pw.nibble, terms=t)
                   - want).abs().max().item() / limit for t in (1, 2)]
        controls.append((f"{name} {row['shape']}", *ratios))
        del want
        if library is None:
            return
        with full_f32():
            lib_out = library()
            print(f"[kernels] {label} library vs kernel: max_abs_diff "
                  f"{(lib_out.reshape(m, n) - run()).abs().max().item():.3e}")
            del lib_out
            row["library_ms"] = timed_ms(library, torch, flush)
        row["ms"] = timed_ms(run, torch, flush)
        row["plain_ms"] = timed_ms(ref, torch, flush)
        row["f32_route_ms"] = f32_row["ms"] = timed_ms(f32, torch, flush)
        # The function's own work: x, codes and sf read once, out written once.
        nbytes = lhs.numel() * 4 + pw.codes.numel() + 4 + m * n * 4
        row.update(bound(2.0 * m * kdim * n, nbytes, "bf16x3"))
        f32_row.update(bound(2.0 * m * kdim * n, nbytes, lhs.dtype))
        row["f32_bound_ms"] = f32_row["bound_ms"]
        f32_row["plain_ms"], f32_row["library_ms"] = row["plain_ms"], row["library_ms"]
        for r in (row, f32_row):
            r["tflops"] = r["flops"] / r["ms"] / 1e9
        rows[name].append(row)
        rows[f32_name].append(f32_row)

    # The five AlexNet convs at batch 64: (input H = W, Cin, k, stride, Cout).
    # Library: cuDNN F.conv2d on the conv input with the dequantized weight.
    convs = [(224, 3, 11, 4, 96), (28, 96, 5, 1, 256), (14, 256, 3, 1, 384),
             (14, 384, 3, 1, 384), (14, 384, 3, 1, 256)]
    for i, (hw, cin, k, stride, cout) in enumerate(convs):
        img = torch.randn(BATCH, hw, hw, cin, device=dev, generator=gen)
        w = torch.randn(k, k, cin, cout, device=dev, generator=gen) * (1.0 / k / math.sqrt(k))
        # as quantized_conv2d gives them: rows 16-byte aligned (conv0: a view, K = 363)
        patches = extract_patches(img, k, k, stride=stride).reshape(-1, k * k * cin)
        pw, _ = ops.pack_conv_weight(w, "elp_bsd_a4")
        wq = ops.dequantize_nd(pw).permute(3, 2, 0, 1).contiguous()
        xi = pad_nhwc(img, k, k, stride, "SAME").permute(0, 3, 1, 2).contiguous()
        library = lambda: F.conv2d(xi, wq, stride=stride).permute(0, 2, 3, 1)  # noqa: E731
        case("elp_bsd_matmul/bf16x3", patches, pw, f"conv{i} a4/nibble", library)
        if i == 1:
            pw, _ = ops.pack_conv_weight(w, "elp_bsd_a4", granularity="per_channel")
            case("elp_bsd_matmul/bf16x3", patches, pw, f"conv{i} a4/nibble per-channel sf")
        if i == 2:
            case("elp_bsd_matmul/bf16x3", patches, ops.pack_conv_weight(w, "elp_bsd_c6")[0],
                 f"conv{i} c6/u8")
        del img, patches, xi

    # The three AlexNet fc layers at M = 64: (K, N). Library: torch.matmul
    # on the dequantized weight.
    fcs = [(12544, 4096), (4096, 4096), (4096, 1000)]
    for i, (kdim, n) in enumerate(fcs):
        xa = torch.relu(torch.randn(BATCH, kdim, device=dev, generator=gen))
        w = torch.randn(kdim, n, device=dev, generator=gen) / math.sqrt(kdim)
        pw, _ = ops.pack_weight(w, "elp_bsd_a4")
        wq = ops.dequantize(pw)
        library = lambda: torch.matmul(xa, wq)  # noqa: E731
        case("fused_decode_matmul/bf16x3", xa, pw, f"fc{i} a4/nibble", library)
        if i == 1:
            case("fused_decode_matmul/bf16x3", xa, ops.pack_weight(w, "elp_bsd_c6")[0],
                 f"fc{i} c6/u8")
        if i == 2:
            pw, _ = ops.pack_weight(w, "elp_bsd_a4", granularity="per_channel")
            case("fused_decode_matmul/bf16x3", xa, pw, f"fc{i} a4/nibble per-channel sf")
    for label, one, two in controls:
        print(f"[kernels] control {label}: one bf16 term of x reads {one:.2f} of the limit "
              f"(must exceed 1), two terms {two:.3f} (reported)")
        if one <= 1.0:
            failures.append(f"the limit does not see a one-term product: {label}")
    for name in under_test:
        for r in rows[name]:
            print(f"[kernels] {name} {r['shape']}: kernel {r['ms']:.4f} ms "
                  f"({r['tflops']:.1f} TFLOP/s; {r['bound_ms'] / r['ms']:.3f} of its bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['f32_bound_ms'] / r['ms']:.3f} "
                  f"of the float32 bound {r['f32_bound_ms']:.4f} ms), f32 kernel "
                  f"{r['f32_route_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms")
        tot = {k: sum(r[k] for r in rows[name])
               for k in ("ms", "f32_route_ms", "plain_ms", "library_ms", "bound_ms",
                         "f32_bound_ms")}
        print(f"[kernels] {name} per AlexNet forward: {tot['ms']:.4f} ms; the f32 kernel it "
              f"replaced {tot['f32_route_ms']:.4f} ms ({tot['f32_route_ms'] / tot['ms']:.2f}x); "
              f"library {tot['library_ms']:.4f} ms; bound {tot['bound_ms']:.4f} ms (three bf16 "
              f"passes, {tot['bound_ms'] / tot['ms']:.3f} of it), {tot['f32_bound_ms']:.4f} ms "
              f"at the float32 rate ({tot['f32_bound_ms'] / tot['ms']:.3f}); plain "
              f"{tot['plain_ms']:.4f} ms")
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

    _zero_counts()
    logits = qm.forward(batch)
    torch.cuda.synchronize()
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    print(f"[main] launches in one forward at batch {BATCH}: {launches}")
    if launches != dict(zip(KERNEL_ROUTES, _expected({"elp_bsd_matmul/bf16x3": 5,
                                                      "fused_decode_matmul/bf16x3": 3}))):
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

    cnn_launches = launches
    del qm, qm_cpu, params, calib, batch, logits, float_card, pairs
    torch.cuda.empty_cache()

    # -- phase 5: the LM path's kernels at its shapes ------------------------------
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for name in ("elp_bsd_matmul/bf16x3", "elp_bsd_matmul/f32", "fused_decode_matmul/bf16x3",
                 "fused_decode_matmul/f32"):
        for r in rows[name]:
            r["weight"] = 1  # each AlexNet shape runs once per forward
    lm_kernel_phase(torch, dev, gen, flush, rows, failures)
    del flush
    torch.cuda.empty_cache()

    # -- phase 6: the LM main path, and phase 7: its kernels held on the card -----
    lm_launches = lm_main_path(torch, dev, failures)

    # -- phase 8: the reduced LM on the card against the CPU -----------------------
    lm_card_vs_cpu(torch, dev, failures)

    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1

    sources = {
        "elp_bsd_matmul/f32": ("src/repro_torch/csrc/elp_bsd_matmul.cu",
                               "src/repro/kernels/elp_bsd_matmul.py:69"),
        "elp_bsd_matmul/wgmma": ("src/repro_torch/csrc/elp_bsd_matmul_wgmma.cu",
                                 "src/repro/kernels/elp_bsd_matmul.py:69"),
        "elp_bsd_matmul/bf16x3": ("src/repro_torch/csrc/elp_bsd_matmul_wgmma.cu",
                                  "src/repro/kernels/elp_bsd_matmul.py:69"),
        "fused_decode_matmul/f32": ("src/repro_torch/csrc/fused_decode.cu",
                                    "src/repro/kernels/fused_decode.py:70"),
        "fused_decode_matmul/wgmma": ("src/repro_torch/csrc/fused_decode_wgmma.cu",
                                      "src/repro/kernels/fused_decode.py:70"),
        "fused_decode_matmul/bf16x3": ("src/repro_torch/csrc/fused_decode_wgmma.cu",
                                       "src/repro/kernels/fused_decode.py:70"),
        "flash_attention/f32": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:71"),
        "flash_attention/wgmma": ("src/repro_torch/csrc/flash_attention_wgmma.cu",
                                  "src/repro/kernels/flash_attention.py:71"),
    }
    kernels = []
    for name, rs in rows.items():
        # both main paths' worth: every shape's time times its launches there
        rs = [r for r in rs if r.get("weight")]
        wsum = lambda key: sum(r["weight"] * r[key] for r in rs)  # noqa: E731
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": cnn_launches.get(name, 0) + lm_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": wsum("ms"),
            "plain_ms": wsum("plain_ms"),
            "bound_ms": wsum("bound_ms"),
            "bound_by": "operations" if wsum("ops_ms") >= wsum("bytes_ms") else "bytes",
            "library_ms": wsum("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
