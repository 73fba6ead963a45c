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
  ``serve.engine.static_generate`` of 16 new tokens for 16 seeded 128-token
  prompts, checking 252 tiled + 36 flash launches in the prefill and 252
  decode-step launches per decode step, all on the wgmma routes (0 on the
  float32 routes); the generated tokens teacher-forced
  through the same packed model with every kernel swapped for its plain
  version, logits compared, beside controls of that comparison (correct
  changes of rounding and planted faults) and the same reading with float
  activations; greedy ``QuantizedModel.generate`` through
  ``batch_generate`` and the engine on 8 of the prompts (launches exact, a
  row parting from the lockstep tokens only at a plain near-tie); the
  serving engine at the same width: 24 seeded requests (prompts of 48-400
  tokens, half behind one shared 128-token prefix, 8-16 new tokens) into 8
  slots, (a) ``QuantizedModel.serve`` on the dense cache, (b) the paged
  cache with static int8 K/V, (c) (b) with ngram speculative decoding, (d) a
  ``QuantScheme.speculative`` artifact (a4 draft, float verify tier), its
  save/load held bit-identical on the draft tier and one verify layer,
  serving the first 8 requests from memory with model drafts; each run's
  launches exact per model call, every request complete, admissions in
  submission order, the page pool
  drained and its prefix hits those the requests imply (a shared-prefix
  admission with another such request live finds the prefix's pages), its
  tokens teacher-forced through the same model with its kernels and with
  their plain versions (logits within the LM gate; every token within the
  gate of the top logit of both, with controls of wrong tokens that must
  fail), TTFT from the requests' own samples, ITL from the obs histograms,
  tokens/s; every kernel shape those runs gave a wrapper (decode and verify
  steps, ragged admissions on both matmul routes, flash at ragged S) held
  against its plain version on the run's own inputs and timed; and the reduced 2-layer qwen3-8b on the card
  against the CPU;
* the paper's Sec. V slice, after the AlexNet path: ALEXNET_MINI and
  VGG_MINI trained on the card at the JAX package's budget (1200 momentum-SGD
  steps, batch 128) with ``repro_torch.experiments.common.train_mini_cnn``;
  Fig. 15(a) (``fig15a.run``, ``run_activation``) and Fig. 15(b)
  (``fig15b.run``, every Table II format at activation bits 8..4, packed on
  the kernels) with their rows and claim lines, each Fig. 15(b) accuracy held
  within the search's ``ac`` (0.01) of the same weights on the CPU, exact
  launches per packed forward (3 tiled + 2 decode-step bf16x3 for
  ALEXNET_MINI, 4 + 2 for VGG_MINI); the quickstart example's flow
  (``api.quantize(..., eval_fn=...)`` on card and CPU: the same CBW_A, the
  codes that differ counted; the packed artifact's eval on the kernels,
  ``save``, ``load``, a bit-identical forward); the same search on
  full-width ALEXNET with seeded weights (agreement with the float model's
  argmax as its eval_fn), its packed agreement within 0.01 of its float
  twin's, save/load bit-identical; and the bf16x3 routes' distance from a
  float64 sum for 1, 2 and 3 bf16 terms at K from 363 to 25088 (gated: the
  kernel under half the limit at every K, one term over it).
  The kernel phase also times every GEMM shape of these forwards.
* the MoE family at full-width olmoe-1b-7b and the VLM stub at internvl2-26b
  (4 of 48 layers), after the LM path (``moe_phase``, ``vlm_phase``);
* the recurrent and enc-dec families at full width and depth
  (``family_phase``): mamba2-780m, recurrentgemma-2b and
  seamless-m4t-large-v2, each with seeded weights, ``api.quantize`` (a4 per
  slice, float activations) and ``QuantizedModel.generate`` of 16 new
  tokens for 16 seeded 128-token prompts (seamless also 16 x 200 seeded
  frame embeddings, ragged against the flash block), through
  ``batch_generate`` to ``static_generate``; launches exact per prefill and
  decode step (derived from the packed tree), prefill and decode timed, the
  tokens teacher-forced against the plain versions under the LM gate beside
  each model's controls (float64 sums, a bf16 step, the decode-step K-tail
  skip, and for seamless non-causal flash attending zero-padded keys), and
  every kernel shape of the generate held against its plain version;
* the paper's second network, full-width VGG16 (``vgg16_phase``, after
  the LM phases): seeded weights, ``api.quantize`` (a4, static 8-bit activations
  calibrated on seeded images) and ``QuantizedModel.forward`` at batch 64,
  13 tiled + 3 decode-step bf16x3 launches a forward, every kernel shape
  held against its plain version on the run's own inputs beside cuDNN /
  ``torch.matmul``, forward time and peak memory, card against CPU at
  batch 2;
* the paper's remaining results on the minis mini_phase trained
  (``paper_results_phase``): Sec. VI-D ``caxcnn_compare`` (card and CPU),
  ``calib_bench`` (dynamic against static activations on the packed
  forward: 0 range reductions static, one a site dynamic, launches exact)
  and ``table2_energy``, each printing the JAX scripts' rows;
* LM training on one card (``train_phase``, last): lm-100m (the JAX
  package's ``examples/train_lm.py`` config) straight, checkpointed and
  resumed (the resumed losses held to the straight run's) and with each
  gradient codec; lm-ptq's first steps card against CPU; qwen3-8b at full
  width, 4 of 36 layers, bf16 with float32 masters; no kernel launched in
  any training step; then ``lm_ptq`` as the script runs it;
* the mesh layer on one card (the mesh phase): ``elastic.make_mesh()`` starts
  a one-rank NCCL group and lays the (1, 1) ("data", "model") mesh over it
  before the LM path; (a) inside the LM path, qwen3-8b on the engine with the
  mesh and ``flash_decode=True`` (dense and paged int8, the first 8 engine
  requests) beside the meshless engine: launches exact per call and equal,
  the meshed tokens under the teacher-forced gate, ``flash_decode_attention``
  against ``attention_dot`` in float32 on the run's own first decode-step
  cache; (b) inside the MoE phase, olmoe-1b-7b ``static_generate`` through
  ``moe_ep`` at its capacity factor (launches exact, the dropped share), and
  ``moe_ep`` against ``moe_dense`` and the partial sum of the kept choices on
  the run's own layer-0 input, placed by the same products in float64; (c)
  after training, lm-100m on the mesh with and without int8 compression
  (losses equal to the meshless run's) and a mesh checkpoint resumed without
  one; (d) ``compressed_mean`` on the NCCL group against the codec's round
  trip; (e) the collectives each part issued by kind (0 where the path has
  one fails the run). Their kernel shapes are the meshless runs' shapes,
  held there; their launches join the kernels line;
* tensor parallelism (the TP phase, last but one): two processes share the
  card over a ``gloo`` group (NCCL refuses two ranks on one device) on a
  (1, 2) mesh, each loading the checksummed artifacts that the LM, MoE and
  family phases saved and resharding them: (a) qwen3-8b through
  ``ServeSetup(mesh)`` + ``static_generate`` at the lockstep geometry,
  launches per route per rank exact, collectives by kind exact, the model
  teacher-forced on the meshless tokens within the LM gate of the meshless
  kernels' logits, prefill and decode ms and peak memory per rank, with the
  same comparison on float activations in bf16 and in a float32 copy of the
  tree (within 1e-4) as its controls; (b)
  olmoe-1b-7b, the prefill and 3 decode steps through ``moe_ep`` (launches
  and collectives exact, the dropped share), then with the routing forced
  to the meshless plain run's: the MoE gates; every new sharded kernel
  shape of (a) and (b) held against its plain version on the run's own
  inputs; (c) lm-100m 20 steps with and without ``seq_parallel``, the
  losses within 1e-5 relative of the meshless run's, no kernel launched, a
  checkpoint of the mesh run resumed on the mesh and without one; (d) the
  qwen3-8b continuous-batching engine over the ranks (``_tp_engine``) on the
  (1, 2) mesh and a (2, 1) one: launches and collectives exact, tokens equal
  on both ranks and in the gate, prefix hits the meshless engine's, every
  kernel shape of its runs held against its plain version; (e) mamba2-780m,
  recurrentgemma-2b and seamless-m4t-large-v2 at full width and depth from
  their family phases' artifacts through ``static_generate`` (the first 8 of
  the family phase's new tokens; launches and
  collectives exact, tokens equal on both ranks, the model teacher-forced on
  the meshless tokens within the family's gate, every kernel shape held),
  then mamba2-780m at 4 of 48 layers in float32, 2 train steps on the mesh
  against 2 without it. Its times are of two ranks sharing one card over a
  host wire;
* the dry-run and step-cost tooling (the cost phase, last): (a)
  ``python -m repro_torch.launch.dryrun`` for qwen3-8b x decode_32k (elp4)
  and olmoe-1b-7b x train_4k on the 16 x 16 mesh of a fake process group,
  each in a process of its own, each cell ``ok``, its roofline terms
  printed; (b) the dry-run's (1, 1) cell of qwen3-8b elp4 at 16 slots x 4096
  positions counted on ``meta``, then the same decode step on the card with
  seeded random codes under ``count_cost``: FLOPs, bytes, wire bytes,
  kernel calls by route (equal to the launch counters) and argument bytes
  equal to the meta count, the predicted peak within 15 % of
  ``max_memory_allocated``, the step's time beside its roofline terms, every
  kernel shape held; (c) ``repro_torch.experiments.serve_quantized
  --speculative`` (both drafters token-identical to static generation),
  every kernel shape held;
* the port's ``bench/`` (the bench phase, after the cost phase), on an
  autotune cache of its own (every other phase dispatches on an empty one,
  the heuristic): (a) the tuner at qwen3-8b's four decode-step [K, N] at M
  16-384 (bf16, the wgmma routes) and AlexNet's eight GEMMs at batch 64
  (float32, the bf16x3 routes), each impl and the library call timed, the M
  at which the winner turns from the decode-step kernel to the tiled one,
  and flash-decode's chunk at 16 x 32 x 128 x 4096; (b) ``impl="auto"``
  launching a cache entry's kernel (held), flash-decode's ``block_s=None``
  equal to the tuned chunk's call, ``QuantScheme(block_sizes="auto")`` on
  the tuned cache against the default scheme on an empty one (logits within
  1e-4 of max |logit|, the empty cache's launches the heuristic's); (c)
  ``python -m repro_torch.bench --smoke`` in this process, both documents
  validated and gated against themselves. Its launches are printed on a
  line of their own and are not in the kernels line.

    python3 chip_smoke.py

Exits non-zero on any failure, and without a result when there is no
CUDA device. The last line is the JSON device record; the line before it
holds the card's name and power limit, and before that one JSON object
with each kernel route's numbers: ``launches`` counts its launches on the
main paths (one AlexNet forward, the Sec. V phases, one generate, the
engine phase, the MoE and VLM phases, one generate of each recurrent and
enc-dec model, one VGG16 forward, the paper-results phase, the mesh phase, both
ranks of the TP phase, the cost phase's counted step and serve_quantized), and
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are the per-shape
times of those launches, each shape weighted by its launches (a Sec. V shape
is timed once per format, an engine shape at the inputs of its first call). The three ``/f32`` routes have no
launch on either path: the matmuls' times are those of AlexNet's shapes
(one forward's worth, the kernel launched directly), flash's those of the
prefill's attention shape in float32, weighted as one generate's 36
launches. Every time is the device's: a launch is queued behind a device
sleep, so the host's own time to issue it is not counted.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import shutil
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
LM_ENGINE_GEN_ROWS = 8  # QuantizedModel.generate through the engine: 8 of the 16 prompts
# The serving engine's traffic at full-width qwen3-8b: seeded requests into
# ENGINE_SLOTS slots of ENGINE_MAX_LEN positions; prompt lengths on both
# matmul routes (<= 256 rows: decode-step; above: tiled) and ragged flash
# shapes; half the prompts begin with one shared ENGINE_PREFIX-token prefix
# (lengths 160-400); ENGINE_NEW new tokens each.
ENGINE_REQUESTS, ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_PAGE = 24, 8, 512, 16
ENGINE_LENGTHS = (48, 96, 160, 320, 400)
ENGINE_PREFIX = 128
ENGINE_NEW = (8, 16)
ENGINE_SPEC_K = 4
# (d), model drafts against the float verify tier (each round W - 1 draft
# steps and one verify), serves the first ENGINE_SPEC_REQUESTS requests; the
# profiled run makes PROFILED_NEW tokens a request (5 decode steps and more).
ENGINE_SPEC_REQUESTS = 8
PROFILED_NEW = 8


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


def _phased(torch, fn):
    """``fn()`` (synchronised) with the launches of each model call the engine
    module makes counted on their own (its model API is wrapped here, in this
    script only): returns (result, [(label, _counts() delta), ...])."""
    import repro_torch.serve.engine as engine_mod

    phases = []
    real_get_model = engine_mod.get_model

    def counting_get_model(cfg_):
        inner = real_get_model(cfg_)

        def wrap(f, label):
            def call(*args, **kwargs):
                before = _counts()
                out = f(*args, **kwargs)
                phases.append((label, tuple(a - b for a, b in zip(_counts(), before))))
                return out
            return call

        return dataclasses.replace(inner, prefill=wrap(inner.prefill, "prefill"),
                                   decode_step=wrap(inner.decode_step, "decode"))

    engine_mod.get_model = counting_get_model
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        engine_mod.get_model = real_get_model
    return out, phases


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


def lm_main_path(torch, dev, failures, rows, mesh=None, mesh_report=None) -> tuple:
    """Full-width qwen3-8b: seeded params, api.quantize, static_generate (the
    lockstep loop, comparable with earlier runs); then the same packed model with
    each kernel swapped for its plain version; greedy QuantizedModel.generate
    through batch_generate and the engine; then the serving engine's phase, and
    with ``mesh`` the mesh phase's part (a). Returns the launches of the static
    generate and of the engine phase."""
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
    # static_generate counted on its own.
    setup = engine_mod.ServeSetup(cfg=cfg, mesh=None, max_len=LM_PROMPT + LM_NEW, batch=LM_BATCH)

    def static_run():
        return engine_mod.static_generate(setup, qm.params, {"tokens": prompts}, LM_NEW)

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    new, phases = _phased(torch, static_run)
    gen_first_s = time.perf_counter() - t0
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
    again = static_run()
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
    tp_save(torch, qm, "qwen3_8b", prompts=prompts, tokens=new, logits=kernel_logits,
            prefill_ms=statistics.median(pre_ms[1:]), decode_ms=statistics.median(later_steps),
            calib=calib)

    # Greedy QuantizedModel.generate routes through batch_generate to the
    # engine: one slot per row, each admission a 128-token prefill (the
    # decode-step route), then decode steps at M = 8. Its tokens against the
    # lockstep ones: a row may part from them only with a token within the
    # gate of the plain top logit (another float32 order, another 8-bit
    # rounding). Its kernel shapes go to the engine phase's tap.
    rows8 = LM_ENGINE_GEN_ROWS
    tap = KernelTap()
    _zero_counts()
    with tap:
        t0 = time.perf_counter()
        via_engine = qm.generate(prompts[:rows8], LM_NEW)
        torch.cuda.synchronize()
        eng_gen_s = time.perf_counter() - t0
    want_gen = tuple(rows8 * a + (LM_NEW - 1) * b for a, b in zip(
        _expected({"fused_decode_matmul/wgmma": n_layers * per_layer,
                   "flash_attention/wgmma": n_layers}),
        _expected({"fused_decode_matmul/wgmma": n_layers * per_layer})))
    if _counts() != want_gen:
        failures.append(f"generate via the engine: launches {_counts()}, expected {want_gen}")
    plain8 = [pl[:rows8, -1] for pl in plain_logits]
    parted = _first_partings(via_engine, new[:rows8], plain8)
    print(f"[lm] QuantizedModel.generate via batch_generate (engine, {rows8} slots): "
          f"{eng_gen_s * 1e3:.1f} ms, launches {dict(zip(KERNEL_ROUTES, _counts()))}; rows "
          f"identical to static_generate {rows8 - len(parted)}/{rows8}; partings (row, "
          f"position, the engine token's plain logit below the top / max |logit|) {parted}")
    for row, j, gap in parted:
        if gap > LM_LOGIT_REL_TOL:
            failures.append(f"generate via the engine parts from static_generate at row {row} "
                            f"position {j} with a token {gap:.3e} below the plain top logit")
    # Control of that gate: the engine's tokens shifted by one position must part
    # from the lockstep ones with a token far below the plain top.
    shifted = torch.cat([via_engine[:, 1:], via_engine[:, -1:]], 1)
    worst = max((g for *_, g in _first_partings(shifted, new[:rows8], plain8)), default=0.0)
    print(f"[lm-control] generate via the engine, its tokens shifted by one position: largest "
          f"gap at a parting {worst:.3e} of max |logit| (must exceed {LM_LOGIT_REL_TOL:g})")
    if worst <= LM_LOGIT_REL_TOL:
        failures.append("the engine parting gate does not see tokens shifted by one position")
    gen_launches = _counts()

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
    del kernel_logits, plain_logits
    torch.cuda.empty_cache()
    engine_launches = engine_phase(torch, dev, qm, cfg, calib, failures, tap, rows)
    if mesh is not None:
        mesh_serve_phase(torch, dev, qm, cfg, calib, failures, mesh, mesh_report)
    engine_launches = {k: engine_launches[k] + v for k, v in zip(KERNEL_ROUTES, gen_launches)}
    del qm, p
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
    c = speculative_phase(torch, dev, cfg, calib, failures, rows)
    engine_launches = {k: engine_launches[k] + v for k, v in c.items()}
    held = {k: sum(r["weight"] for r in rows[k] if r.get("engine")) for k in KERNEL_ROUTES}
    print(f"[engine] launches of the engine phase, all runs {engine_launches}; launches of the "
          f"shapes held against their plain versions {held}")
    if held != engine_launches:
        failures.append(f"[engine] launches {engine_launches} but held shapes cover {held}")
    return launches, engine_launches


def engine_requests(vocab: int) -> list:
    """The engine phase's seeded requests: ``[(prompt int32, max_new), ...]``."""
    import numpy as np

    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, ENGINE_PREFIX)
    long = [s for s in ENGINE_LENGTHS if s > ENGINE_PREFIX]
    reqs = []
    for i in range(ENGINE_REQUESTS):
        if i % 2 == 0:  # shared prefix, then its own tokens
            s = long[(i // 2) % len(long)]
            prompt = np.concatenate([prefix, rng.integers(0, vocab, s - ENGINE_PREFIX)])
        else:
            prompt = rng.integers(0, vocab, ENGINE_LENGTHS[(i // 2) % len(ENGINE_LENGTHS)])
        reqs.append((prompt.astype(np.int32), int(rng.integers(ENGINE_NEW[0], ENGINE_NEW[1] + 1))))
    return reqs


def _first_partings(got, want, plain) -> list:
    """Rows where token streams ``got`` and ``want`` ([B, n]) first part:
    ``(row, position, gap)`` with ``plain[j]`` the plain logits [B, V] at
    position j, teacher-forced on ``want`` (so on ``got`` up to the parting),
    and gap how far ``got``'s token sits below the plain top logit there, in
    units of max |logit|."""
    out = []
    for row in range(got.shape[0]):
        diff = (got[row] != want[row]).nonzero()
        if len(diff):
            j = int(diff[0])
            lg = plain[j][row]
            out.append((row, j, ((lg.max() - lg[got[row, j].long()]) / lg.abs().max()).item()))
    return out


def _token_gaps(torch, logits: list, outs: list) -> list:
    """``(request, position, gap)`` wherever a token of ``outs`` (int arrays) is
    not the argmax of its logits (``logits[i]`` [n_i, V]): gap is how far the
    token's logit sits below the top one, in units of the request's max |logit|."""
    import numpy as np

    gaps = []
    for i, (lg, o) in enumerate(zip(logits, outs)):
        tok = torch.from_numpy(np.asarray(o, np.int64)).to(lg.device)
        gap = (lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]) / lg.abs().max()
        for j in (tok != lg.argmax(-1)).nonzero()[:, 0].tolist():
            gaps.append((i, j, gap[j].item()))
    return gaps


def _engine_forced(torch, transformer, params, cfg, reqs, outs, kv_scales=None):
    """Logits at every generated position of every request, teacher-forced: one
    prefill of each prompt and its generated tokens (right-padded into one
    batch) through a dense cache, or the static int8 cache with ``kv_scales``
    (the layout of ``static_generate(kv_scales=...)``). Returns a list of
    [n_i, V] float32 tensors."""
    import numpy as np

    seqs = [np.concatenate([p, o[:-1]]) for (p, _), o in zip(reqs, outs)]
    length = max(len(q) for q in seqs)
    toks = np.zeros((len(seqs), length), np.int64)
    for i, q in enumerate(seqs):
        toks[i, :len(q)] = q
    dev = params["embed"].device
    with torch.no_grad():
        x = transformer.embed_tokens(params, cfg, torch.from_numpy(toks).to(dev))
        cache = transformer.init_cache(cfg, len(seqs), length, kv_scales=kv_scales, device=dev)
        x, _ = transformer.stack_apply(params["blocks"], cfg, x, causal=True, window=cfg.window,
                                       cache=cache, cache_pos=0)
        rows = torch.tensor([i for i, o in enumerate(outs) for _ in range(len(o))], device=dev)
        cols = torch.tensor([len(p) - 1 + j for (p, _), o in zip(reqs, outs)
                             for j in range(len(o))], device=dev)
        logits = transformer.unembed(params, cfg, x[rows, cols][None])[0]
    del cache, x
    return list(torch.split(logits, [len(o) for o in outs]))


def _serve_run(torch, label, run, reqs, failures, tap, *, paged: bool, per_layer: int = 7,
               readings: dict | None = None):
    """Drive one engine run (``run(metrics, trace)`` serves ``reqs``) under the
    kernel ``tap``, counting every launch per model call from zero (the engine's
    prefill, decode_step, verify and draft calls); check the counts per call
    (``per_layer`` packed block matmuls a layer), completion and the page pool;
    print the obs readings: TTFT and prefill from the requests' own samples (the
    trace's admissions), ITL as the obs histogram's bucket bounds (steps of
    2^0.25, about 19 %). ``readings`` gets the TTFT samples (ms). Returns
    (outs, engine, launches)."""
    import numpy as np

    import repro_torch.serve.engine as engine_mod
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.obs.metrics import Registry
    from repro_torch.obs.trace import TraceLog
    from repro_torch.serve.paging import PageTable

    calls, engines = [], []

    def counting_get_model(cfg_):
        inner = real_get_model(cfg_)

        def wrap(fn, label_):
            def call(params, cfg__, tokens, cache, *args, **kwargs):
                before = _counts()
                out = fn(params, cfg__, tokens, cache, *args, **kwargs)
                t = tokens["tokens"] if isinstance(tokens, dict) else tokens
                packed = isinstance(params["blocks"]["wq"], PackedWeight)
                calls.append((label_, t.numel(), packed,
                              tuple(a - b for a, b in zip(_counts(), before))))
                return out
            return call

        return dataclasses.replace(inner, prefill=wrap(inner.prefill, "prefill"),
                                   decode_step=wrap(inner.decode_step, "decode_step"))

    real_get_model, real_engine = engine_mod.get_model, engine_mod.ServeEngine

    class RecordedEngine(real_engine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    engine_mod.get_model, engine_mod.ServeEngine = counting_get_model, RecordedEngine
    reg, log = Registry(enabled=True), TraceLog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        with tap:
            t0 = time.perf_counter()
            outs = run(reg, log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine_mod.get_model, engine_mod.ServeEngine = real_get_model, real_engine
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    peak = torch.cuda.max_memory_allocated()
    eng = engines[-1]
    n_layers = eng.cfg.n_layers
    # Per call: every block matmul of a packed tier on the route M picks, the
    # flash kernel in a dense admission's prefill, nothing else.
    wrong = []
    for label_, m, packed, got in calls:
        want = {}
        if packed:
            want["fused_decode_matmul/wgmma" if m <= 256 else "elp_bsd_matmul/wgmma"] = (
                per_layer * n_layers)
        if label_ == "prefill":
            want["flash_attention/wgmma"] = n_layers
        if got != _expected(want):
            wrong.append((label_, m, packed, got))
    kinds = collections.Counter((label_, "M<=256" if m <= 256 else "M>256", packed)
                                for label_, m, packed, _ in calls)
    print(f"[engine] {label}: {len(calls)} model calls, launches exact per call "
          f"{not wrong}; calls by (kind, rows, packed) {dict(kinds)}")
    if wrong:
        failures.append(f"[engine] {label}: launch counts per call {wrong[:4]}")
    st = eng.stats()
    cache = st["cache"]
    n_tok = sum(len(o) for o in outs)
    short = [i for i, ((_, n), o) in enumerate(zip(reqs, outs)) if len(o) != n]
    if short or st["requests_truncated"] or st["requests_completed"] != len(reqs):
        failures.append(f"[engine] {label}: requests short {short}, truncated "
                        f"{st['requests_truncated']}, completed {st['requests_completed']}")
    if any(int(o.min()) < 0 or int(o.max()) >= eng.cfg.vocab for o in outs):
        failures.append(f"[engine] {label}: tokens out of the vocab")
    if paged:
        # What the request set implies: a request behind the shared prefix finds
        # its ENGINE_PREFIX // page_size pages in the pool when another request
        # behind it is live at its admission (admitted, not yet finished); the
        # first finds none. Who is live when is the trace's admit/finish order,
        # and admissions must follow submission order (FIFO).
        heads = collections.Counter(p[:ENGINE_PREFIX].tobytes() for p, _ in reqs)
        shares = [len(p) > ENGINE_PREFIX and heads[p[:ENGINE_PREFIX].tobytes()] > 1
                  for p, _ in reqs]
        index, admitted, live, implied, sharers = {}, [], set(), 0, 0
        for ev in log.events:
            if ev["event"] == "submit":
                index[ev["rid"]] = len(index)
            elif ev["event"] == "admit":
                r = index[ev["rid"]]
                admitted.append(r)
                if shares[r] and any(shares[x] for x in live):
                    implied += ENGINE_PREFIX // eng.setup.page_size
                    sharers += 1
                live.add(r)
            elif ev["event"] == "finish":
                live.discard(index[ev["rid"]])
        # diagnostic: the same admissions and finishes replayed on a fresh page table
        pt = PageTable(eng._sched.n_slots, eng.setup.max_len, eng.setup.page_size,
                       eng._pager.n_pages)
        for ev in log.events:
            if ev["event"] == "admit":
                prompt = reqs[index[ev["rid"]]][0]
                pt.admit(ev["slot"], prompt)
                pt.register(ev["slot"], prompt)
            elif ev["event"] == "finish":
                pt.release(ev["slot"])
        print(f"[engine] {label}: prefix hits {cache['prefix_hits']}, implied {implied} "
              f"({sharers} of {sum(shares)} shared-prefix admissions find a live holder, x "
              f"{ENGINE_PREFIX // eng.setup.page_size} pages; replayed on a fresh page table: "
              f"{pt.prefix_hits}); admissions in submission order {admitted == sorted(admitted)}; "
              f"pages used after the drain {cache['pages_used']} of {cache['pages_total']}, page "
              f"bytes a slot {cache['slot_bytes']:.0f}")
        if (cache["prefix_hits"] != implied or not implied or cache["pages_used"] != 0
                or admitted != list(range(len(reqs)))):
            failures.append(f"[engine] {label}: prefix hits {cache['prefix_hits']} (implied "
                            f"{implied}), pages used {cache['pages_used']}, admission order "
                            f"{admitted}")
    h = reg.histograms()

    def pct(name, q):
        v = h[name].percentile(q) if name in h else None
        return float("nan") if v is None else v * 1e3
    mon = st["straggler"]
    spec = st.get("speculative")
    spec_txt = ""
    if spec:
        acc = h["serve.spec.accepted_per_round"]
        spec_txt = (f"; speculative: {spec['rounds']} rounds, accepted {spec['tokens_accepted']} of "
                    f"{spec['tokens_drafted']} drafted ({spec['acceptance_rate']:.4f}), "
                    f"{acc.mean:.3f} tokens a slot a round (p50 {acc.percentile(50):.0f}), "
                    f"{(n_tok - len(reqs)) / max(spec['rounds'], 1):.3f} a round over all slots")
    admits = [ev for ev in log.events if ev["event"] == "admit"]
    ttft = [ev["ttft_s"] * 1e3 for ev in admits]
    pre = [ev["prefill_s"] * 1e3 for ev in admits]
    if readings is not None:
        readings["ttft_ms"] = ttft
    print(f"[engine] {label}: {len(reqs)} requests, {n_tok} tokens in {wall:.2f} s, "
          f"{n_tok / wall:.1f} tokens/s; TTFT median {statistics.median(ttft):.1f} max "
          f"{max(ttft):.1f} ms; ITL p50 {pct('serve.itl_s', 50):.1f} p99 "
          f"{pct('serve.itl_s', 99):.1f} ms (bucket bounds); decode {st['decode_steps']} steps, "
          f"{mon['median_s'] * 1e3:.1f} ms a step (median; p50 {mon['p50_s'] * 1e3:.1f}, max "
          f"{mon['max_s'] * 1e3:.1f}); {st['prefills']} admissions, prefill median "
          f"{statistics.median(pre):.1f} ms{spec_txt}; modeled "
          f"{st['energy_nj_per_token']:.4g} nJ a token; max_memory_allocated {peak} B")
    if eng.profile is not None:
        # ProfileHook: torch.profiler from the end of the first decode dispatch
        # to the end of the n-th. The device's kernel time (its own events, as
        # scripts/profile_lm_torch.py counts them) against the span of all the
        # trace's events.
        from torch.autograd import DeviceType

        n = eng.profile.n_steps
        events = eng.profile.profiler.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        span_us = (max(e.time_range.end for e in events)
                   - min(e.time_range.start for e in events)) if events else 0
        dev_us = sum(e.time_range.elapsed_us() for e in kernels)
        print(f"[engine] {label}: torch.profiler over decode steps 2-{n}: device kernel time "
              f"{dev_us / 1e3:.1f} ms in a {span_us / 1e3:.1f} ms trace (idle share "
              f"{1 - dev_us / max(span_us, 1):.3f}), {len(kernels) / (n - 1):.0f} device "
              "launches a step")
    return outs, eng, launches


def _engine_held(torch, label, forced_pair, outs, failures, *, gate_tokens=True,
                 tol=LM_LOGIT_REL_TOL) -> None:
    """Teacher-forced logits, kernels against plain versions, under the LM gate.
    Each engine token must sit within the gate of the top logit of both the plain
    and the kernel teacher-forced logits (each token off the argmax printed);
    controls of wrong tokens (shifted by one position, another request's) must
    not. ``gate_tokens=False`` (an MoE model, whose engine run routes free)
    prints the tokens' readings without gating them: a routing flip between the
    engine's float order and the teacher-forced one moves a token's logits far
    past the gate (see ROUTE_FLIP_LIMIT). ``tol`` is the logit gate of the model."""
    import numpy as np

    kernel_l, plain_l = forced_pair
    rel = max((kl - pl).abs().max().item() / pl.abs().max().item()
              for kl, pl in zip(kernel_l, plain_l))
    total = sum(len(o) for o in outs)
    print(f"[engine] {label}: teacher-forced kernels vs plain versions {rel:.3e} of max "
          f"|logit| (limit {tol:g})")
    if rel > tol:
        failures.append(f"[engine] {label}: teacher-forced logits {rel:.3e} relative")
    for which, logits in (("plain", plain_l), ("kernel", kernel_l)):
        gaps = _token_gaps(torch, logits, outs)
        worst = max((g for *_, g in gaps), default=0.0)
        print(f"[engine] {label}: engine token = {which} teacher-forced argmax at "
              f"{total - len(gaps)}/{total} positions; elsewhere (request, position, the "
              f"token's logit below the top / max |logit|) "
              f"{[(i, j, round(g, 6)) for i, j, g in gaps]}; largest {worst:.3e} (limit "
              f"{LM_LOGIT_REL_TOL:g})")
        if gate_tokens and worst > LM_LOGIT_REL_TOL:
            failures.append(f"[engine] {label}: a token {worst:.3e} below the {which} top logit")
    n = len(outs)
    controls = (
        ("each request's tokens shifted by one position",
         [np.concatenate([o[1:], o[-1:]]) for o in outs]),
        ("each request given the next request's tokens",
         [np.resize(outs[(i + 1) % n], len(o)) for i, o in enumerate(outs)]),
    )
    for text, toks in controls:
        gaps = [g for *_, g in _token_gaps(torch, plain_l, toks)]
        worst = max(gaps, default=0.0)
        print(f"[engine-control] {label}: {text}: largest gap below the plain top "
              f"{worst:.3e} of max |logit|, {sum(g > LM_LOGIT_REL_TOL for g in gaps)}/{total} "
              f"positions over the limit (must exceed {LM_LOGIT_REL_TOL:g})")
        if gate_tokens and worst <= LM_LOGIT_REL_TOL:
            failures.append(f"[engine] {label}: the token gate does not see {text}")


def _plain_swapped(torch, fn):
    """``fn()`` with every kernel rebound to its plain version (here only)."""
    import repro_torch.kernels.ops as ops_mod
    import repro_torch.models.transformer as transformer
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul_plain

    saved = (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul, transformer.flash_attention)
    ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul = (elp_bsd_matmul_plain,
                                                           fused_decode_matmul_plain)
    transformer.flash_attention = _plain_flash()
    try:
        return fn()
    finally:
        ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul, transformer.flash_attention = saved


def _forced_pair(torch, params, cfg, reqs, outs, kv_scales, failures):
    """Teacher-forced logits of the requests with the kernels and with their plain
    versions; an MoE model's kernel run takes the plain run's routing (RouteTap),
    and its own top-k sets are held under ROUTE_FLIP_LIMIT."""
    import repro_torch.models.transformer as transformer

    _zero_counts()
    with RouteTap() as plain_route:
        plain_l = _plain_swapped(torch, lambda: _engine_forced(torch, transformer, params, cfg,
                                                               reqs, outs, kv_scales))
    assert not any(_counts()), "the plain teacher-forced run launched kernels"
    with RouteTap(force=plain_route.ids if cfg.is_moe else None) as kernel_route:
        kernel_l = _engine_forced(torch, transformer, params, cfg, reqs, outs, kv_scales)
    if cfg.is_moe:
        share, _ = _route_diff(kernel_route.ids, plain_route.ids, cfg.n_layers, len(reqs))
        print(f"[engine] teacher-forced, routing forced to the plain run's: each layer's own "
              f"top-{cfg.topk} differs from the plain ids in {share:.3e} of the (token, layer) "
              f"sets (limit {ROUTE_FLIP_LIMIT:g})")
        if share > ROUTE_FLIP_LIMIT:
            failures.append(f"[engine] {cfg.name}: teacher-forced routing {share:.3e}")
    return kernel_l, plain_l


class KernelTap:
    """While active, every call the main path makes to a kernel wrapper passes
    through here: the first call of each distinct shape keeps copies of its
    inputs and of the kernel's output (to be held against the plain version on
    the same inputs once the run is over), and every call counts toward its
    shape's weight. It launches nothing of its own."""

    def __init__(self):
        self.calls = {}  # key -> {"name", "args", "kw", "out", "n"}

    def _add(self, key, name, args, n_copied, kw, out):
        """``args[:n_copied]`` are activations (copied); the rest are weights."""
        rec = self.calls.get(key)
        if rec is None:
            self.calls[key] = {"name": name, "kw": kw, "out": out.clone(), "n": 1,
                               "args": tuple(a.clone() for a in args[:n_copied]) + args[n_copied:]}
        else:
            rec["n"] += 1

    def __enter__(self):
        import repro_torch.kernels.ops as ops_mod
        import repro_torch.models.transformer as transformer
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels.elp_bsd_matmul import route

        self._saved = (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul,
                       transformer.flash_attention)
        tiled, fused, flash = self._saved

        def matmul(kernel, name):
            def call(x, codes, sf, fmt, *, nibble=False, out_dtype=None):
                out = kernel(x, codes, sf, fmt, nibble=nibble, out_dtype=out_dtype)
                full = f"{name}/{route(x, fmt)}"
                key = (full, tuple(x.shape), tuple(codes.shape), fmt.name, nibble, out_dtype)
                self._add(key, full, (x, codes, sf, fmt), 1,
                          {"nibble": nibble, "out_dtype": out_dtype}, out)
                return out
            return call

        def attention(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
            out = flash(q, k, v, causal=causal, block_q=block_q, block_k=block_k,
                        q_offset=q_offset)
            full = f"flash_attention/{fa.route(q, k, v)}"
            key = (full, tuple(q.shape), tuple(k.shape), causal, q_offset)
            self._add(key, full, (q, k, v), 3, {"causal": causal, "q_offset": q_offset}, out)
            return out

        ops_mod.elp_bsd_matmul = matmul(tiled, "elp_bsd_matmul")
        ops_mod.fused_decode_matmul = matmul(fused, "fused_decode_matmul")
        transformer.flash_attention = attention
        return self

    def __exit__(self, *exc):
        import repro_torch.kernels.ops as ops_mod
        import repro_torch.models.transformer as transformer

        (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul,
         transformer.flash_attention) = self._saved
        return False


def hold_tapped(torch, dev, label, tap, rows, failures, library_for=None) -> None:
    """Each kernel shape of a run (``tap``), its output from the run held against
    the plain version on the same inputs (matmuls at REL_TOL, flash at
    FLASH_TOL); then the kernel timed at that shape beside the plain version and
    one library call, each row weighted by the shape's calls in the run. A
    matmul's library call is ``torch.matmul`` on the dequantized weight, or
    ``library_for(x, wq)`` where that gives one (a conv's cuDNN call); its bound
    takes its route's arithmetic (bf16x3: three bf16 passes)."""
    import torch.nn.functional as F

    from repro_torch.device import full_f32
    from repro_torch.kernels import ops
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul, elp_bsd_matmul_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul, fused_decode_matmul_plain

    t0 = time.perf_counter()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    kernels = {"elp_bsd_matmul": (elp_bsd_matmul, elp_bsd_matmul_plain),
               "fused_decode_matmul": (fused_decode_matmul, fused_decode_matmul_plain)}
    worst = collections.defaultdict(float)
    for rec in sorted(tap.calls.values(), key=lambda r: (r["name"], r["args"][0].shape)):
        name, args, kw = rec["name"], rec["args"], rec["kw"]
        if name.startswith("flash_attention"):
            q, k, v = args
            run = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
            ref = lambda: flash_attention_plain(q, k, v, **kw)  # noqa: E731
            sq, sk = q.shape[2], k.shape[2]
            mask = None
            if kw["causal"] and kw["q_offset"]:
                mask = (torch.arange(sk, device=q.device)[None, :]
                        <= torch.arange(sq, device=q.device)[:, None] + kw["q_offset"])
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, is_causal=kw["causal"] and mask is None,
                enable_gqa=k.shape[1] != q.shape[1])
            tol = FLASH_TOL[str(q.dtype)[6:]]
            shape = f"q{list(q.shape)} k{list(k.shape)} causal={kw['causal']}"
            cost = _flash_bound(q, k, kw["causal"])
        else:
            x, codes, sf, fmt = args
            kernel, plain = kernels[name.split("/")[0]]
            run = lambda: kernel(x, codes, sf, fmt, **kw)  # noqa: E731
            ref = lambda: plain(x, codes, sf, fmt, **kw)  # noqa: E731
            m, kdim = x.shape
            n = codes.shape[-1]
            wq = ops.dequantize(ops.PackedWeight(codes, sf, fmt.name, kw["nibble"],
                                                 (kdim, n))).to(x.dtype)
            library = library_for(x, wq) if library_for else None
            if library is None:
                library = lambda: torch.matmul(x, wq)  # noqa: E731
            tol = (0.0, REL_TOL)
            shape = f"M={m} K={kdim} N={n}"
            cost = bound(2.0 * m * kdim * n, x.numel() * x.element_size() + codes.numel() + 4
                         + m * n * 4, "bf16x3" if name.endswith("/bf16x3") else x.dtype)
        want = ref()
        got = rec["out"]
        err, w = (got.float() - want.float()).abs().max().item(), _worst(got, want, tol)
        ok = bool(torch.isfinite(got.float()).all()) and w <= 1.0
        worst[name] = max(worst[name], w)
        if not ok:
            failures.append(f"[engine-kernels] {label}: {name} {shape}: worst |err| / limit {w:.3f}")
        row = {"shape": f"{label}: {shape}", "weight": rec["n"], "engine": True,
               "max_abs_err": err}
        with full_f32():
            row["library_ms"] = timed_ms(library, torch, flush)
        row["ms"] = timed_ms(run, torch, flush)
        row["plain_ms"] = timed_ms(ref, torch, flush)
        row.update(cost)
        rows[name].append(row)
        print(f"[engine-kernels] {label}: {name} {shape}: {rec['n']} launches in the run; "
              f"max_abs_err {err:.3e}, worst |err| / limit {w:.3f} {'ok' if ok else 'FAIL'}; "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    for name in sorted(worst):
        rs = [r for r in rows[name] if r.get("engine") and r["shape"].startswith(label)]
        print(f"[engine-kernels] {label}: {name}: {len(rs)} shapes held, worst |err| / limit "
              f"{worst[name]:.3f} (limit 1), {sum(r['weight'] for r in rs)} launches; "
              f"kernel {sum(r['weight'] * r['ms'] for r in rs):.3f} ms over them, plain "
              f"{sum(r['weight'] * r['plain_ms'] for r in rs):.3f} ms, bound "
              f"{sum(r['weight'] * r['bound_ms'] for r in rs):.3f} ms, library "
              f"{sum(r['weight'] * r['library_ms'] for r in rs):.3f} ms")
    tap.calls.clear()
    del flush
    torch.cuda.empty_cache()
    print(f"[time] engine kernel shapes held, {label}: {time.perf_counter() - t0:.1f} s")


def engine_phase(torch, dev, qm, cfg, calib, failures, tap, rows) -> dict:
    """The continuous-batching engine at full-width qwen3-8b on the packed a4,
    static 8-bit model of the LM phase: (a) QuantizedModel.serve on the dense
    cache; (b) the paged cache, static int8 K/V with calibrated scales; (c) (b)
    with ngram speculative decoding. Each run's tokens are teacher-forced
    through the same model with its kernels and with their plain versions;
    every kernel shape the runs (and the generate before them, in ``tap``)
    gave a wrapper is then held against its plain version. Returns the
    launches of the runs."""
    import tempfile

    import repro_torch.serve.engine as engine_mod
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.obs.trace import ProfileHook

    t_phase = time.perf_counter()
    reqs = engine_requests(cfg.vocab)
    lens = collections.Counter(len(p) for p, _ in reqs)
    print(f"[engine] {len(reqs)} requests, prompt lengths {dict(sorted(lens.items()))}, "
          f"half starting with one shared {ENGINE_PREFIX}-token prefix; new tokens {sum(n for _, n in reqs)} ({ENGINE_NEW[0]}-{ENGINE_NEW[1]} each); "
          f"{ENGINE_SLOTS} slots of {ENGINE_MAX_LEN}")
    t0 = time.perf_counter()
    scales = calibrate_kv_cache(qm.params, cfg, calib)
    print(f"[engine] calibrate_kv_cache on {tuple(calib.shape)} tokens: "
          f"{time.perf_counter() - t0:.1f} s")
    total = collections.Counter()
    geom = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN)
    paged = dict(kv_cache="paged", page_size=ENGINE_PAGE, kv_scales=scales)
    prof_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    runs = [
        ("(a) dense, QuantizedModel.serve", False, None,
         lambda reg, log: qm.serve(reqs, metrics=reg, trace=log, **geom)),
        ("(b) paged int8", True, scales,
         lambda reg, log: engine_mod.ServeEngine(cfg, qm.params, metrics=reg, trace=log, **geom,
                                                 **paged).serve(reqs)),
        ("(c) paged int8, ngram spec_k 4", True, scales,
         lambda reg, log: engine_mod.ServeEngine(cfg, qm.params, metrics=reg, trace=log, spec_k=ENGINE_SPEC_K,
                                      spec_draft="ngram", **geom, **paged).serve(reqs)),
    ]
    for label, is_paged, kv, run in runs:
        outs, eng, launches = _serve_run(torch, label, run, reqs, failures, tap, paged=is_paged)
        total.update(launches)
        del eng
        t0 = time.perf_counter()
        _engine_held(torch, label, _forced_pair(torch, qm.params, cfg, reqs, outs, kv, failures),
                     outs, failures)
        print(f"[engine] {label}: teacher-forced checks {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    # The device's share of a decode step, apart from the runs above (the
    # profiler slows the host): (b)'s engine on the first ENGINE_SLOTS
    # requests, cut to PROFILED_NEW new tokens, decode steps 2-5 under
    # torch.profiler.
    first = [(p, min(n, PROFILED_NEW)) for p, n in reqs[:ENGINE_SLOTS]]
    _, eng, launches = _serve_run(
        torch, f"(b) profiled, the first {ENGINE_SLOTS} requests, {PROFILED_NEW} new tokens",
        lambda reg, log: engine_mod.ServeEngine(cfg, qm.params, metrics=reg, trace=log,
                                                profile=ProfileHook(prof_dir, 5), **geom,
                                                **paged).serve(first),
        first, failures, tap, paged=True)
    total.update(launches)
    del eng
    shutil.rmtree(prof_dir, ignore_errors=True)
    hold_tapped(torch, dev, "generate + engine (a)-(c)", tap, rows, failures)
    print(f"[time] engine phase (a)-(c): {time.perf_counter() - t_phase:.1f} s")
    return {k: total[k] for k in KERNEL_ROUTES}


def speculative_phase(torch, dev, cfg, calib, failures, rows) -> dict:
    """(d): a QuantScheme.speculative artifact (a4 static draft tier, the float
    verify tier) of the seeded qwen3-8b weights. Its save/load is held
    bit-identical on the whole draft tier and one layer of the verify tier;
    the artifact in memory then serves the first ENGINE_SPEC_REQUESTS
    requests on the paged int8 cache with model drafts, and its kernel shapes are held against their plain
    versions. Returns its launches."""
    import tempfile

    import repro_torch.models.transformer as transformer
    import repro_torch.serve.engine as engine_mod
    from repro_torch import api
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.checkpoint.manager import _flatten

    t_phase = time.perf_counter()
    reqs = engine_requests(cfg.vocab)[:ENGINE_SPEC_REQUESTS]
    params = transformer.init_params(cfg, seed=0)
    scheme = api.QuantScheme.speculative(draft="elp_bsd_a4", K=ENGINE_SPEC_K, act="static")
    t0 = time.perf_counter()
    qs = api.quantize(cfg, params, scheme, calib_data=calib)
    del params
    scales = calibrate_kv_cache(qs.verify_params, cfg, calib)
    torch.cuda.synchronize()
    print(f"[engine] (d) api.quantize({scheme.spec_verify} verify tier, {scheme.fmt} draft, K "
          f"{scheme.spec_k}) and K/V scales: {time.perf_counter() - t0:.1f} s")
    # The save/load round trip: the whole draft tier, and of the verify tier
    # (36 float layers, the bulk of the bytes) its first layer.
    part = api.QuantizedModel(
        qs.params, qs.adapter, qs.scheme, table=qs.table, report=qs.report,
        verify_params={"blocks": {k: v[:1] for k, v in qs.verify_params["blocks"].items()}})
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        part.save(tmp)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)
        t0 = time.perf_counter()
        loaded = api.load(tmp)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(
        a.dtype == b.dtype and torch.equal(a, b)
        for tree, other in ((part.params, loaded.params), (part.verify_params,
                                                            loaded.verify_params))
        for a, b in zip(_flatten(tree).values(), _flatten(other).values()))
    same = (same and loaded.scheme == scheme and loaded.table == qs.table
            and _flatten(loaded.params).keys() == _flatten(part.params).keys()
            and _flatten(loaded.verify_params).keys() == _flatten(part.verify_params).keys())
    print(f"[engine] (d) artifact of the draft tier and verify layer 0: {nbytes} B on disk, "
          f"save {save_s:.1f} s, load {load_s:.1f} s; bit-identical after load {same}")
    if not same:
        failures.append("[engine] (d) the speculative artifact does not load bit-identical")
    del part, loaded
    torch.cuda.empty_cache()
    label = "(d) speculative artifact, model drafts, paged int8"
    tap = KernelTap()
    outs, eng, launches = _serve_run(
        torch, label, lambda reg, log: engine_mod.ServeEngine(
            cfg, qs.verify_params, draft_params=qs.params, spec_k=qs.scheme.spec_k,
            spec_draft=qs.scheme.spec_draft, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
            metrics=reg, trace=log, kv_cache="paged", page_size=ENGINE_PAGE,
            kv_scales=scales).serve(reqs),
        reqs, failures, tap, paged=True)
    del eng
    _engine_held(torch, label, _forced_pair(torch, qs.verify_params, cfg, reqs, outs, scales,
                                            failures), outs, failures)
    hold_tapped(torch, dev, "engine (d)", tap, rows, failures)
    del qs, tap
    torch.cuda.empty_cache()
    print(f"[time] engine phase (d): {time.perf_counter() - t_phase:.1f} s")
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


# The MoE and VLM slice (the transformer families beside dense). olmoe-1b-7b
# at full width and depth: a4 codes, static 8-bit activations, the experts on
# the dense MoE form (every expert on every token, dequantized whole at every
# call, as the JAX package runs MoE without a mesh); static_generate at the LM
# phase's geometry, then the engine on the engine phase's traffic, dense (a)
# and paged int8 (b). internvl2-26b at full width, its depth cut to
# VLM_LAYERS of 48 (48 layers are about 40 GB of bf16 weights), batch
# VLM_BATCH, each prompt VLM_FRONTEND seeded frontend embeddings and VLM_TEXT
# seeded tokens.
MOE_PER_LAYER = 4  # wq, wk, wv, wo on the kernels; the experts are bmm
VLM_LAYERS, VLM_BATCH, VLM_TEXT, VLM_NEW = 4, 4, 128, 8
VLM_PER_LAYER = 7
# internvl2's logit gate (kernels against plain versions, teacher-forced),
# placed by the vlm phase's own controls (PR 19's second chip run): every
# kernel's function summed in float64 reads 5.5e-2 of max |logit| (the kernels
# 5.8e-2; the frontend's 256 positions and static 8-bit activations calibrated
# on text), every matmul output moved one bf16 step 0.17, the decode-step
# matmul skipping its last 128 K rows 0.64. A query that also sees the next key
# reads 6.7e-2, within the noise: that subtle fault is for the elementwise
# flash check (hold_tapped); flash letting each query see the next 128 keys
# must trip the gate.
VLM_LOGIT_REL_TOL = 0.15
# Routing flips. Teacher-forced on the same tokens, the kernels' float32 and
# bf16 rounding moves a router logit by a little; where a token's 8th and 9th
# experts lie closer than that, the two runs pick different experts. With the
# reference's init (expert weights at fan-in E: each expert's output far larger
# than the residual) a flip moves that token's residual, and through attention
# every later token's, by far more than the rounding does, so flips cascade:
# run free, the plain run against itself with every kernel's function summed
# in float64 differs in a quarter of all (token, layer) top-8 sets (PR 19's
# first chip run). That share cannot tell a correct change of rounding from a
# fault, so it is reported, and the LM logit gate holds on the positions routed
# alike in every layer. The gates proper run with the routing forced: every
# run takes the plain run's expert ids (its gates from its own logits at those
# ids), and each layer's own top-8 is recorded. Then a flip cannot cascade; the
# share of own top-8 sets that differ from the plain ids (at most
# ROUTE_FLIP_LIMIT) measures the router's inputs layer by layer, and the logit
# gate (MOE_LOGIT_REL_TOL) holds at every position. Both limits are placed by
# controls (MOE_CONTROL_STEPS positions; PR 19's second chip run, routing
# forced): every kernel's function summed in float64 moves 8.1e-2 of the own
# top-8 sets and 5.4e-2 of max |logit| (the kernels read 9.2e-2 and 6.0e-2:
# sixteen layers of static 8-bit activations and experts far larger than the
# residual amplify a change of rounding more than qwen3-8b's 36 layers, whose
# float64 control reads 3.7e-2); every matmul output moved one bf16 step (more
# than a correct kernel does) 0.56 and 0.31; planted faults 1.0 of the sets
# (experts off by one, the top-8 of the wrong logits) and 1.24 of max |logit|
# (the decode-step matmul skipping its last 128 K rows). Each limit sits
# between the float64 control and the bf16-step one.
ROUTE_FLIP_LIMIT = 0.25
MOE_LOGIT_REL_TOL = 0.15
MOE_CONTROL_STEPS = 4
MOE_ENGINE_REQUESTS = 4  # the MoE engine runs' share of the engine phase's requests


class RouteTap:
    """While active, the expert ids every ``router_gates`` call picks, in call
    order (one a layer per model call), each row sorted (a top-k set).
    ``force`` (such a list from another run) makes call ``i`` route to
    ``force[i]`` instead, with gates from its own logits at those ids;
    ``fault`` plants a routing fault in what the router picks:
    ``"off_by_one"`` (every id + 1) or ``"wrong_logits"`` (the top-k of the
    negated router logits). Under tensor parallelism the router's logits
    arrive gathered, and a rank (``rank``) of the expert exchange routes its
    share of a call's tokens: it is forced to that share of ``force[i]``."""

    def __init__(self, force=None, fault=None, rank=0):
        self.ids, self.force, self.fault, self.rank = [], force, fault, rank

    def __enter__(self):
        import torch

        import repro_torch.models.moe as moe
        from repro_torch.device import full_f32

        self._real = real = moe.router_gates

        def gates(x2d, router, topk, logits=None):
            if logits is None:
                with full_f32():
                    logits = torch.matmul(x2d.float(), router.float())
            if self.fault == "wrong_logits":
                logits = -logits
            g, ids = real(None, None, topk, logits)
            if self.fault == "off_by_one":
                ids = (ids + 1) % logits.shape[1]
            self.ids.append(ids.sort(dim=-1).values)
            if self.force is None:
                return g, ids
            ids = self.force[len(self.ids) - 1]
            if ids.shape[0] != logits.shape[0]:  # a tensor-parallel rank's share of the tokens
                n = logits.shape[0]
                ids = ids[self.rank * n:(self.rank + 1) * n]
            return logits.gather(1, ids).softmax(dim=-1), ids

        moe.router_gates = gates
        return self

    def __exit__(self, *exc):
        import repro_torch.models.moe as moe

        moe.router_gates = self._real
        return False


def _route_diff(a_ids, b_ids, n_layers, batch):
    """(share of (token, layer) top-k sets that differ, per model call a [batch]
    mask: the token whose logits the call returns (a prefill's last) routed
    alike in every layer)."""
    differ = total = 0
    matched = []
    for c in range(len(a_ids) // n_layers):
        ok = None
        for layer in range(n_layers):
            d = (a_ids[c * n_layers + layer] != b_ids[c * n_layers + layer]).any(-1)
            differ += int(d.sum())
            total += d.numel()
            same = ~d.view(batch, -1)[:, -1]
            ok = same if ok is None else ok & same
        matched.append(ok)
    return differ / total, matched


def _rel_where(got: list, want: list, masks: list) -> tuple:
    """Largest max |got - want| / max |want| over the rows of each position a mask
    keeps, and how many rows it kept."""
    worst, n = 0.0, 0
    for a, b, m in zip(got, want, masks):
        if bool(m.any()):
            worst = max(worst, (a - b).abs()[m].max().item() / b.abs().max().item())
            n += int(m.sum())
    return worst, n


def _collect(torch) -> int:
    """Collect the earlier phases' garbage (engines and caches in reference cycles)
    and return the device memory still allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _swapped(mm, flash):
    """A context in which the matmul kernels and flash are rebound (here only)."""
    import contextlib

    import repro_torch.kernels.ops as ops_mod
    import repro_torch.models.transformer as transformer

    @contextlib.contextmanager
    def ctx():
        saved = (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul, transformer.flash_attention)
        (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul), transformer.flash_attention = \
            mm, flash
        try:
            yield
        finally:
            (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul,
             transformer.flash_attention) = saved
    return ctx()


def _moe_profile(torch, transformer, params, cfg, prompts, tokens, steps: int = 4) -> dict:
    """torch.profiler over ``steps`` lockstep decode steps (after a prefill, not
    traced): the device ms a step under the expert dequantize (``moe._dq``), the
    expert products (``moe._bmm_f32``) and in all, and the wall ms a step."""
    import repro_torch.models.moe as moe
    from torch.profiler import ProfilerActivity, profile, record_function

    real_dq, real_bmm = moe._dq, moe._bmm_f32

    def dq(w, dtype):
        with record_function("moe._dq"):
            return real_dq(w, dtype)

    def bmm(a, b):
        with record_function("moe._bmm_f32"):
            return real_bmm(a, b)

    cache = transformer.init_cache(cfg, prompts.shape[0], prompts.shape[1] + steps + 1)
    _, cache = transformer.prefill(params, cfg, prompts, cache)
    torch.cuda.synchronize()
    moe._dq, moe._bmm_f32 = dq, bmm
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                transformer.decode_step(params, cfg, tokens[:, i:i + 1], cache,
                                        prompts.shape[1] + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        moe._dq, moe._bmm_f32 = real_dq, real_bmm
    avg = {e.key: e for e in prof.key_averages()}

    def dev_ms(key):
        e = avg.get(key)
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) if e else 0
        return t / 1e3 / steps

    from torch.autograd import DeviceType

    # device kernels only: the ranges' own device-side annotations are not work
    kernels = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.name.startswith("moe."))
    return {"dq_ms": dev_ms("moe._dq"), "bmm_ms": dev_ms("moe._bmm_f32"),
            "device_ms": kernels / 1e3 / steps, "wall_ms": wall,
            "dq_calls": avg["moe._dq"].count // steps if "moe._dq" in avg else 0,
            "bmm_calls": avg["moe._bmm_f32"].count // steps if "moe._bmm_f32" in avg else 0}


def moe_phase(torch, dev, failures, rows, mesh=None, mesh_report=None) -> dict:
    """Full-width olmoe-1b-7b: seeded params, api.quantize, static_generate
    (launches per prefill and decode step exact), teacher-forced kernels vs
    plain with the routing-flip gate and its controls, the expert dequantize and
    bmm under torch.profiler, then the engine (a) dense and (b) paged int8, each
    run's launches exact per call and its tokens held against the teacher-forced
    logits; every kernel shape of the phase held against its plain version; with
    ``mesh`` the mesh phase's part (b). Returns the phase's launches."""
    import repro_torch.models.transformer as transformer
    import repro_torch.serve.engine as engine_mod
    from repro_torch import api
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.configs import get_config
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul_plain

    import repro_torch.kernels.ops as ops_mod

    t_phase = time.perf_counter()
    resident = _collect(torch)
    cfg = get_config("olmoe_1b_7b")
    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(6)
    calib = torch.randint(0, cfg.vocab, (2, 4, LM_PROMPT), device=dev, generator=gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device=dev, generator=gen)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for k, v in params.items() if k != "blocks")
    n_par += sum(v.numel() for v in params["blocks"].values())
    print(f"[moe] seeded {cfg.name} params ({n_par} weights, {cfg.dtype}; {cfg.n_experts} experts "
          f"top-{cfg.topk}, {n_layers} layers) on the card in {time.perf_counter() - t0:.1f} s; "
          f"param_count {cfg.param_count()}, active {cfg.active_param_count()}; "
          f"memory_allocated before the phase {resident} B")
    t0 = time.perf_counter()
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act="static"), calib_data=calib)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    blocks = qm.params["blocks"]
    n_slices = sum(int(math.prod(v.codes.shape[:-2])) for v in blocks.values()
                   if hasattr(v, "codes"))
    print(f"[moe] conversion s {conv_s:.2f} (api.quantize: calibrate on 2x4x{LM_PROMPT} tokens, "
          f"pack {n_slices} slices: {n_layers * MOE_PER_LAYER} attention, "
          f"{n_slices - n_layers * MOE_PER_LAYER} expert); packed bytes "
          f"{qm.report.packed_weight_bytes}; memory_allocated {torch.cuda.memory_allocated()} B; "
          f"expert act scales: we1 {blocks['we1'].act_scale}, we2 {blocks['we2'].act_scale} "
          "(stamped as the reference stamps them, unused by the expert path)")

    # static_generate, counted per model call, its kernel shapes tapped
    setup = engine_mod.ServeSetup(cfg=cfg, mesh=None, max_len=LM_PROMPT + LM_NEW, batch=LM_BATCH)
    tap = KernelTap()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with tap:
        t0 = time.perf_counter()
        new, phases = _phased(torch, lambda: engine_mod.static_generate(
            setup, qm.params, {"tokens": prompts}, LM_NEW))
        first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    prefill_counts = _expected({"elp_bsd_matmul/wgmma": n_layers * MOE_PER_LAYER,
                                "flash_attention/wgmma": n_layers})
    step_counts = _expected({"fused_decode_matmul/wgmma": n_layers * MOE_PER_LAYER})
    want_phases = [("prefill", prefill_counts)] + [("decode", step_counts)] * (LM_NEW - 1)
    print(f"[moe] launches {KERNEL_ROUTES} by phase of the generate: prefill "
          f"{phases[0][1] if phases else None}, decode steps "
          f"{sorted(set(p_[1] for p_ in phases[1:]))} over {len(phases) - 1} steps (expected "
          f"{prefill_counts} and {step_counts})")
    if phases != want_phases:
        failures.append(f"[moe] launch counts by phase {phases}")
    if (tuple(new.shape) != (LM_BATCH, LM_NEW) or int(new.min()) < 0
            or int(new.max()) >= cfg.vocab):
        failures.append(f"[moe] generated tokens of shape {tuple(new.shape)} or out of the vocab")
    t0 = time.perf_counter()
    again = engine_mod.static_generate(setup, qm.params, {"tokens": prompts}, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(again, new):
        failures.append("[moe] a second generate gave other tokens")
    print(f"[moe] generate ({LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_NEW} new): first "
          f"{first_s * 1e3:.1f} ms, second {gen_s * 1e3:.1f} ms; tokens/s "
          f"{LM_BATCH * LM_NEW / gen_s:.1f} (second run); max_memory_allocated {peak} B")
    p = qm.params
    cache = transformer.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW)
    pre_ms, step_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(p, cfg, prompts, cache)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(3):
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(p, cfg, new[:, i:i + 1], cache, LM_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[moe] prefill ms at b{LM_BATCH} s{LM_PROMPT}: median {statistics.median(pre_ms):.2f} "
          f"(runs {[round(t, 2) for t in pre_ms]}); decode ms/step at b{LM_BATCH}: median "
          f"{statistics.median(step_ms):.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f})")
    prof = _moe_profile(torch, transformer, p, cfg, prompts, new)
    print(f"[moe] torch.profiler over 4 decode steps at b{LM_BATCH}: a step {prof['wall_ms']:.1f} "
          f"ms wall, {prof['device_ms']:.1f} ms of device kernels; expert dequantize "
          f"{prof['dq_ms']:.2f} device ms a step ({prof['dq_calls']} calls), expert bmm "
          f"{prof['bmm_ms']:.2f} device ms a step ({prof['bmm_calls']} calls)")

    # Teacher-forced on the generated tokens, every (token, layer) top-8 set
    # recorded: first run free (the kernels against the plain versions, the
    # positions routed alike), then with the routing forced to the plain run's.
    plain_mm = (elp_bsd_matmul_plain, fused_decode_matmul_plain)
    kernel_mm = (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul)

    def forced(mm, flash, *, steps=LM_NEW, force=None, fault=None):
        with _swapped(mm, flash), RouteTap(force, fault) as rt:
            logits_ = _teacher_forced(torch, transformer, p, cfg, prompts, new[:, :steps], cache)
        return logits_, rt.ids

    t0 = time.perf_counter()
    _zero_counts()
    p_logits, p_ids = forced(plain_mm, _plain_flash())
    if any(_counts()):
        failures.append(f"[moe] the plain run launched kernels {_counts()}")
    _zero_counts()
    k_logits, k_ids = forced(kernel_mm, transformer.flash_attention)
    if _counts() != tuple(a + (LM_NEW - 1) * b for a, b in zip(prefill_counts, step_counts)):
        failures.append(f"[moe] the teacher-forced kernel run launched {_counts()}")
    n_sets = LM_BATCH * (LM_PROMPT + LM_NEW - 1) * n_layers
    share, matched = _route_diff(k_ids, p_ids, n_layers, LM_BATCH)
    rel, n_matched = _rel_where(k_logits, p_logits, matched)
    ctl = MOE_CONTROL_STEPS * n_layers  # router calls of the controls' positions
    f_logits, f_ids = forced((_f64_sum,) * 2, _flash_f64, steps=MOE_CONTROL_STEPS)
    f_share, f_matched = _route_diff(f_ids, p_ids[:ctl], n_layers, LM_BATCH)
    f_rel, f_n = _rel_where(f_logits, p_logits, f_matched)
    print(f"[moe] routing run free, teacher-forced ({time.perf_counter() - t0:.1f} s): kernels vs "
          f"plain versions: top-{cfg.topk} sets that differ {share:.3e} of {n_sets} (token, "
          f"layer) sets; {n_matched}/{LM_BATCH * LM_NEW} positions routed alike in every layer, "
          f"their max |logit diff| / max |logit| {rel:.3e} (limit {MOE_LOGIT_REL_TOL:g}), all "
          f"positions {_rel(k_logits, p_logits):.3e}. Control, every kernel's function summed in "
          f"float64 ({MOE_CONTROL_STEPS} positions): sets that differ {f_share:.3e}; "
          f"{f_n}/{LM_BATCH * MOE_CONTROL_STEPS} positions alike, their logits {f_rel:.3e}")
    if rel > MOE_LOGIT_REL_TOL or not n_matched:
        failures.append(f"[moe] run free: logits at the {n_matched} positions routed alike "
                        f"{rel:.3e}")
    del k_logits, k_ids, f_logits, f_ids
    k_logits, k_ids = forced(kernel_mm, transformer.flash_attention, force=p_ids)
    share, _ = _route_diff(k_ids, p_ids, n_layers, LM_BATCH)
    rel = _rel(k_logits, p_logits)
    print(f"[moe] routing forced to the plain run's: kernels vs plain versions: each layer's own "
          f"top-{cfg.topk} differs from the plain ids in {share:.3e} of {n_sets} (token, layer) "
          f"sets (limit {ROUTE_FLIP_LIMIT:g}); max |logit diff| / max |logit| over all "
          f"{LM_BATCH * LM_NEW} positions {rel:.3e} (limit {MOE_LOGIT_REL_TOL:g})")
    if share > ROUTE_FLIP_LIMIT or rel > MOE_LOGIT_REL_TOL:
        failures.append(f"[moe] routing forced, kernels vs plain: routing {share:.3e}, logits "
                        f"{rel:.3e}")
    n = TP_MOE_STEPS
    tp_save(torch, qm, "olmoe_1b_7b", prompts=prompts, tokens=new[:, :n],
            plain_ids=p_ids[:n * n_layers], plain_logits=p_logits[:n], logits=k_logits[:n])
    del k_logits, k_ids
    step_gen = torch.Generator(device=dev).manual_seed(7)
    controls = [
        ("noise", "every kernel's function summed in float64, rounded once",
         (_f64_sum,) * 2, _flash_f64, None),
        ("noise", "every matmul output moved one bf16 step up or down",
         tuple(_bf16_step(f, step_gen) for f in plain_mm), _plain_flash(), None),
        ("fault", "experts off by one (every routed id + 1)", plain_mm, _plain_flash(),
         "off_by_one"),
        ("fault", "routing to the top-k of the negated router logits", plain_mm, _plain_flash(),
         "wrong_logits"),
        ("fault", "the decode-step matmul skips its last 128 K rows",
         (elp_bsd_matmul_plain, _skip_k_tail), _plain_flash(), None),
    ]
    for kind, label, mm, flash, fault in controls:
        c_logits, c_ids = forced(mm, flash, steps=MOE_CONTROL_STEPS, force=p_ids, fault=fault)
        c_share, _ = _route_diff(c_ids, p_ids[:ctl], n_layers, LM_BATCH)
        c_rel = _rel(c_logits, p_logits)
        print(f"[moe-control] routing forced, {kind}: {label}: own top-{cfg.topk} sets that differ "
              f"{c_share:.3e} (limit {ROUTE_FLIP_LIMIT:g}); logits {c_rel:.3e} (limit "
              f"{MOE_LOGIT_REL_TOL:g})")
        if kind == "fault" and not (c_share > ROUTE_FLIP_LIMIT or c_rel > MOE_LOGIT_REL_TOL):
            failures.append(f"[moe] the routing and logit gates do not see the fault: {label}")
        del c_logits, c_ids
    del p_logits, p_ids
    torch.cuda.empty_cache()
    hold_tapped(torch, dev, "moe static_generate", tap, rows, failures)

    # The engine on the engine phase's first MOE_ENGINE_REQUESTS requests (a
    # decode step takes 0.6 s here, and the phases share the script's limit):
    # (a) dense through QuantizedModel.serve, (b) the paged static int8 cache.
    reqs = engine_requests(cfg.vocab)[:MOE_ENGINE_REQUESTS]
    scales = calibrate_kv_cache(qm.params, cfg, calib)
    geom = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN)
    runs = [
        ("moe (a) dense, QuantizedModel.serve", False, None,
         lambda reg, log: qm.serve(reqs, metrics=reg, trace=log, **geom)),
        ("moe (b) paged int8", True, scales,
         lambda reg, log: engine_mod.ServeEngine(cfg, qm.params, metrics=reg, trace=log, **geom,
                                                 kv_cache="paged", page_size=ENGINE_PAGE,
                                                 kv_scales=scales).serve(reqs)),
    ]
    total = collections.Counter(launches)
    for label, is_paged, kv, run in runs:
        outs, eng, got = _serve_run(torch, label, run, reqs, failures, tap, paged=is_paged,
                                    per_layer=MOE_PER_LAYER)
        total.update(got)
        del eng
        t0 = time.perf_counter()
        _engine_held(torch, label, _forced_pair(torch, qm.params, cfg, reqs, outs, kv, failures),
                     outs, failures, gate_tokens=False, tol=MOE_LOGIT_REL_TOL)
        print(f"[moe] {label}: teacher-forced checks {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    hold_tapped(torch, dev, "moe engine (a)-(b)", tap, rows, failures)
    if mesh is not None:
        mesh_moe_phase(torch, dev, qm, cfg, prompts, new, failures, mesh, mesh_report)
    del qm, p, cache
    torch.cuda.empty_cache()
    print(f"[time] moe phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: total[k] for k in KERNEL_ROUTES}


def vlm_phase(torch, dev, failures, rows) -> dict:
    """internvl2-26b at full width, VLM_LAYERS of its 48 layers: seeded params,
    api.quantize, static_generate on frontend batches (launches per prefill and
    decode step exact: frontend_proj and the block matmuls on the tiled route),
    teacher-forced kernels vs plain under the LM gate with a planted fault; every
    kernel shape held against its plain version. Returns the phase's launches."""
    import repro_torch.models.transformer as transformer
    import repro_torch.serve.engine as engine_mod
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul_plain

    t_phase = time.perf_counter()
    resident = _collect(torch)
    full = get_config("internvl2_26b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    n_front = cfg.frontend_tokens
    params = transformer.init_params(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(8)
    calib = torch.randint(0, cfg.vocab, (2, 4, VLM_TEXT), device=dev, generator=gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (VLM_BATCH, VLM_TEXT), device=dev,
                                     generator=gen),
             "frontend": torch.randn(VLM_BATCH, n_front, cfg.d_model, device=dev,
                                     generator=gen).to(cfg.dtype)}
    t0 = time.perf_counter()
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act="static"), calib_data=calib)
    torch.cuda.synchronize()
    print(f"[vlm] {cfg.name}: full width, {VLM_LAYERS} of {full.n_layers} layers (48 are about "
          f"{full.param_count() * 2 / 1e9:.0f} GB in bf16); conversion s "
          f"{time.perf_counter() - t0:.2f}; frontend {n_front} embeddings + {VLM_TEXT} tokens, "
          f"batch {VLM_BATCH}; memory_allocated before the phase {resident} B")
    del params
    torch.cuda.empty_cache()
    n = n_front + VLM_TEXT
    setup = engine_mod.ServeSetup(cfg=cfg, mesh=None, max_len=n + VLM_NEW, batch=VLM_BATCH)
    tap = KernelTap()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with tap:
        t0 = time.perf_counter()
        new, phases = _phased(torch, lambda: engine_mod.static_generate(setup, qm.params, batch,
                                                                          VLM_NEW))
        gen_s = time.perf_counter() - t0
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    prefill_counts = _expected({"elp_bsd_matmul/wgmma": VLM_LAYERS * VLM_PER_LAYER + 1,
                                "flash_attention/wgmma": VLM_LAYERS})
    step_counts = _expected({"fused_decode_matmul/wgmma": VLM_LAYERS * VLM_PER_LAYER})
    print(f"[vlm] launches {KERNEL_ROUTES} by phase: prefill {phases[0][1] if phases else None}, "
          f"decode steps {sorted(set(p_[1] for p_ in phases[1:]))} over {len(phases) - 1} steps "
          f"(expected {prefill_counts} and {step_counts}); generate {gen_s * 1e3:.1f} ms, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    if phases != [("prefill", prefill_counts)] + [("decode", step_counts)] * (VLM_NEW - 1):
        failures.append(f"[vlm] launch counts by phase {phases}")
    if tuple(new.shape) != (VLM_BATCH, VLM_NEW) or int(new.max()) >= cfg.vocab:
        failures.append(f"[vlm] generated tokens of shape {tuple(new.shape)}")
    p = qm.params
    cache = transformer.init_cache(cfg, VLM_BATCH, n + VLM_NEW)
    pre_ms, step_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = transformer.prefill(p, cfg, batch["tokens"], cache, frontend=batch["frontend"])
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(3):
            t0 = time.perf_counter()
            transformer.decode_step(p, cfg, new[:, i:i + 1], cache, n + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[vlm] prefill ms at b{VLM_BATCH} s{n}: median {statistics.median(pre_ms):.2f}; "
          f"decode ms/step median {statistics.median(step_ms):.2f}")

    def forced(mm, flash):
        with _swapped(mm, flash):
            logits, c = transformer.prefill(p, cfg, batch["tokens"], cache,
                                            frontend=batch["frontend"])
            out = [logits]
            for i in range(VLM_NEW - 1):
                logits, c = transformer.decode_step(p, cfg, new[:, i:i + 1], c, n + i)
                out.append(logits)
        return out

    import repro_torch.kernels.ops as ops_mod

    plain_mm = (elp_bsd_matmul_plain, fused_decode_matmul_plain)
    k_logits = forced((ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul),
                      transformer.flash_attention)
    p_logits = forced(plain_mm, _plain_flash())
    rel = _rel(k_logits, p_logits)
    per_pos = [(a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(k_logits, p_logits)]
    agree = sum(int((new[:, j] == pl[:, -1].argmax(-1)).sum()) for j, pl in enumerate(p_logits))
    print(f"[vlm] kernels vs plain versions, teacher-forced: {rel:.3e} of max |logit| (limit "
          f"{VLM_LOGIT_REL_TOL:g}; per position {[f'{r:.2e}' for r in per_pos]}); greedy = "
          f"plain argmax at {agree}/{VLM_BATCH * VLM_NEW}")
    if rel > VLM_LOGIT_REL_TOL:
        failures.append(f"[vlm] logits: kernels vs plain {rel:.3e}")
    step_gen = torch.Generator(device=dev).manual_seed(9)
    controls = [
        ("noise", "every kernel's function summed in float64, rounded once",
         (_f64_sum,) * 2, _flash_f64),
        ("noise", "every matmul output moved one bf16 step up or down",
         tuple(_bf16_step(f, step_gen) for f in plain_mm), _plain_flash()),
        ("fault", "the decode-step matmul skips its last 128 K rows",
         (elp_bsd_matmul_plain, _skip_k_tail), _plain_flash()),
        ("subtle fault", "flash lets each query see the next key", plain_mm,
         _plain_flash(shift=1)),
        ("fault", "flash lets each query see the next 128 keys", plain_mm,
         _plain_flash(shift=128)),
    ]
    for kind, label, mm, flash in controls:
        r = _rel(forced(mm, flash), p_logits)
        print(f"[vlm-control] {kind}: {label}: {r:.3e} of max |logit| (limit "
              f"{VLM_LOGIT_REL_TOL:g})")
        if kind == "fault" and r <= VLM_LOGIT_REL_TOL:
            failures.append(f"[vlm] the logit gate does not see the planted fault: {label}")
    hold_tapped(torch, dev, "vlm static_generate", tap, rows, failures)
    del qm, p, cache, k_logits, p_logits
    torch.cuda.empty_cache()
    print(f"[time] vlm phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# The recurrent and enc-dec families at full width and depth: mamba2-780m
# (ssm), recurrentgemma-2b (hybrid) and seamless-m4t-large-v2 (audio: an
# encoder over FAMILY_FRAMES seeded frame embeddings a prompt, 200 being
# ragged against the flash kernel's 128-row block), each with seeded weights,
# api.quantize (a4 codes per layer slice, float activations: the only scheme
# the reference serves these families with) and QuantizedModel.generate of
# LM_NEW tokens for LM_BATCH seeded prompts of LM_PROMPT tokens, which
# batch_generate sends to static_generate. Their logit gate is the LM's
# (LM_LOGIT_REL_TOL), each model's controls beside it, except where those
# controls place it elsewhere (FAMILY_LOGIT_REL_TOL). mamba2-780m's, on an
# H100 80GB HBM3 at 700 W (PERF.md): every kernel's function summed in
# float64 (a correct result) reads 5.1e-2 of max |logit| against the plain
# versions, over the LM gate (the kernels 5.7e-2), every matmul output moved
# one bf16 step 0.13, the decode-step K-tail skip 1.44; so its gate sits at
# 0.1, between the float64 control and the bf16 step. recurrentgemma-2b (float64 3.8e-2,
# the kernels 4.1e-2, a bf16 step 0.105) and seamless (1.3e-2, 1.3e-2,
# 1.6e-2) hold the LM gate.
FAMILY_ARCHS = ("mamba2_780m", "recurrentgemma_2b", "seamless_m4t_large_v2")
FAMILY_FRAMES = 200
FAMILY_LOGIT_REL_TOL = {"mamba2_780m": 0.1}


def _flash_zero_keys(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
    """A planted fault: a non-causal call's keys padded with zeros to the 128-row
    block and attended unmasked (the plain version over the padded keys)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_plain

    if not causal:
        pad = (-k.shape[2]) % 128
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)


def _family_launches(cfg, params) -> tuple:
    """Kernel launches of one prefill and of one decode step, from the packed tree:
    every packed layer slice runs once a prefill on the tiled route (M = batch x
    prompt, or x frames on the encoder side); a decode step runs the decoder's
    slices, on the decode-step route at M = batch except the cross-attention's
    xk/xv, which read the encoder output (M = batch x frames, the tiled route).
    Flash runs a prefill's unwindowed attention with head_dim <= 128: none in
    mamba2 (no attention) or recurrentgemma (a window, head_dim 256); in the
    enc-dec model the encoder's self-attention and the decoder's self- and
    cross-attention, one launch a layer each."""
    from repro_torch.kernels.flash_attention import MAX_HD
    from repro_torch.kernels.ops import PackedWeight

    def slices(tree) -> int:
        if isinstance(tree, dict):
            return sum(slices(v) for v in tree.values())
        return (tree.n_layers or 1) if isinstance(tree, PackedWeight) else 0

    total = slices(params)
    if cfg.family in ("encdec", "audio"):
        cross = slices({k: params["decoder"][k] for k in ("xk", "xv")})
        step_fused = slices(params["decoder"]) - cross
        flash = cfg.n_layers + 2 * cfg.n_dec_layers if cfg.hd <= MAX_HD else 0
    else:
        cross, step_fused, flash = 0, total, 0
    return (_expected({"elp_bsd_matmul/wgmma": total, "flash_attention/wgmma": flash}),
            _expected({"fused_decode_matmul/wgmma": step_fused, "elp_bsd_matmul/wgmma": cross}))


def family_phase(torch, dev, failures, rows, arch: str) -> dict:
    """One recurrent or enc-dec model at full width and depth: seeded params,
    api.quantize, QuantizedModel.generate (launches per prefill and decode step
    exact); prefill and decode timed; the generated tokens teacher-forced
    through the packed model with its kernels and with their plain versions
    under the LM gate, beside its controls; every kernel shape of the generate
    held against its plain version on the run's own inputs; the artifact, the
    prompts and the meshless run's tokens and teacher-forced kernel logits saved
    for the TP phase's part (e). Returns the generate's launches."""
    import repro_torch.kernels.ops as ops_mod
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_decode import fused_decode_matmul_plain
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.models import get_model

    t_phase = time.perf_counter()
    resident = _collect(torch)
    cfg = get_config(arch)
    model = get_model(cfg)
    tag = f"[{cfg.family}]"
    params = model.init_params(cfg, seed=0)
    gen = torch.Generator(device=dev).manual_seed(10)
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device=dev,
                                     generator=gen)}
    frames = FAMILY_FRAMES if cfg.family in ("encdec", "audio") else 0
    if frames:
        batch["frontend"] = torch.randn(LM_BATCH, frames, cfg.d_model, device=dev,
                                        generator=gen).to(cfg.dtype)
    n_par = sum(v.numel() for v in tree_leaves(params))
    t0 = time.perf_counter()
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4"))
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    prefill_counts, step_counts = _family_launches(cfg, qm.params)
    print(f"{tag} {cfg.name}: full width and depth, {n_par} seeded weights ({cfg.dtype}); "
          f"conversion s {conv_s:.2f} (a4 per slice, float activations); code + sf bytes "
          f"{qm.report.packed_weight_bytes}; batch {LM_BATCH} x {LM_PROMPT} tokens"
          f"{f' + {frames} frames' if frames else ''}, {LM_NEW} new; memory_allocated before "
          f"the phase {resident} B")
    tap = KernelTap()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with tap:
        t0 = time.perf_counter()
        new, phases = _phased(torch, lambda: qm.generate(batch, LM_NEW))
        gen_s = time.perf_counter() - t0
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} launches {KERNEL_ROUTES} by phase: prefill {phases[0][1] if phases else None}, "
          f"decode steps {sorted(set(p_[1] for p_ in phases[1:]))} over {len(phases) - 1} steps "
          f"(expected {prefill_counts} and {step_counts}); generate {gen_s * 1e3:.1f} ms, "
          f"tokens/s {LM_BATCH * LM_NEW / gen_s:.1f}, max_memory_allocated {peak} B")
    if phases != [("prefill", prefill_counts)] + [("decode", step_counts)] * (LM_NEW - 1):
        failures.append(f"{tag} {cfg.name}: launch counts by phase {phases}")
    if (tuple(new.shape) != (LM_BATCH, LM_NEW) or int(new.min()) < 0
            or int(new.max()) >= cfg.vocab):
        failures.append(f"{tag} {cfg.name}: generated tokens of shape {tuple(new.shape)}")

    p = qm.params
    max_len = LM_PROMPT + LM_NEW

    def fresh():
        return model.init_cache(cfg, LM_BATCH, max_len, device=dev)

    pre_ms, step_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = model.prefill(p, cfg, batch, fresh())
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(4):
            t0 = time.perf_counter()
            _, state = model.decode_step(p, cfg, new[:, i:i + 1], state, LM_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"{tag} prefill ms at b{LM_BATCH} s{LM_PROMPT}: median {statistics.median(pre_ms):.2f} "
          f"(runs {[round(t, 2) for t in pre_ms]}); decode ms/step median "
          f"{statistics.median(step_ms):.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f})")

    def forced(mm, flash) -> list:
        with _swapped(mm, flash):
            logits, state = model.prefill(p, cfg, batch, fresh())
            out = [logits]
            for i in range(LM_NEW - 1):
                logits, state = model.decode_step(p, cfg, new[:, i:i + 1], state,
                                                  LM_PROMPT + i)
                out.append(logits)
        return out

    t0 = time.perf_counter()
    tol = FAMILY_LOGIT_REL_TOL.get(arch, LM_LOGIT_REL_TOL)
    plain_mm = (elp_bsd_matmul_plain, fused_decode_matmul_plain)
    k_logits = forced((ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul), flash_attention)
    p_logits = forced(plain_mm, _plain_flash())
    rel = _rel(k_logits, p_logits)
    agree = sum(int((new[:, j] == pl[:, -1].argmax(-1)).sum()) for j, pl in enumerate(p_logits))
    print(f"{tag} kernels vs plain versions, teacher-forced: {rel:.3e} of max |logit| (limit "
          f"{tol:g}; per position "
          f"{[f'{(a - b).abs().max().item() / b.abs().max().item():.2e}' for a, b in zip(k_logits, p_logits)]}"
          f"); greedy = plain argmax at {agree}/{LM_BATCH * LM_NEW}")
    step_gen = torch.Generator(device=dev).manual_seed(11)
    controls = [
        ("noise", "every kernel's function summed in float64, rounded once",
         (_f64_sum,) * 2, _flash_f64),
        ("noise", "every matmul output moved one bf16 step up or down",
         tuple(_bf16_step(f, step_gen) for f in plain_mm), _plain_flash()),
        ("fault", "the decode-step matmul skips its last 128 K rows",
         (elp_bsd_matmul_plain, _skip_k_tail), _plain_flash()),
    ]
    if frames:
        controls.append(("fault", "non-causal flash attends the zero keys padding it to the "
                         "128-row block", plain_mm, _flash_zero_keys))
    for kind, label, mm, flash in controls:
        r = _rel(forced(mm, flash), p_logits)
        print(f"{tag}-control {kind}: {label}: {r:.3e} of max |logit| (limit {tol:g})")
        if kind == "fault" and r <= tol:
            failures.append(f"{tag} {cfg.name}: the logit gate does not see the planted fault: "
                            f"{label}")
    if rel > tol:
        failures.append(f"{tag} {cfg.name}: logits, kernels vs plain {rel:.3e}")
    print(f"{tag} teacher-forced checks {time.perf_counter() - t0:.1f} s")
    hold_tapped(torch, dev, f"{cfg.name} generate", tap, rows, failures)
    tp_save(torch, qm, arch, prompts=batch["tokens"], frames=batch.get("frontend"), tokens=new,
            logits=k_logits, prefill_ms=statistics.median(pre_ms),
            decode_ms=statistics.median(step_ms))
    del qm, p, k_logits, p_logits, state
    torch.cuda.empty_cache()
    print(f"[time] {cfg.family} phase ({cfg.name}): {time.perf_counter() - t_phase:.1f} s")
    return launches


# The Sec. V slice. AC is the search's own accuracy budget (QuantScheme.ac):
# card and CPU accuracies of the same weights must agree within it, or the
# two devices could pick different bit-widths. Mini CNNs train at the JAX
# package's budget (benchmarks/common.py: 1200 steps, batch 128, lr 2e-2,
# seed 0) and evaluate on its 8 held-out batches of 128.
AC = 0.01
MINI_SPECS = ("ALEXNET_MINI", "VGG_MINI")
FMT_NAMES = ("elp_bsd_a4", "elp_bsd_b7", "elp_bsd_c6", "elp_bsd_d6")
FIG15B_ACT_BITS = (8, 7, 6, 5, 4)
EVAL_BATCHES, EVAL_BATCH = 8, 128
# Contraction lengths of the bf16x3 accuracy sweep: AlexNet's conv0 (363),
# conv1 (2400) and conv3 (3456), VGG16's late convs (4608) and fc0 (25088).
BF16X3_KS = (363, 2400, 3456, 4608, 25088)
BF16X3_K_GATE = 0.5  # of the REL_TOL limit, at every K of the sweep
# The packed forwards of the AlexNet main path (one, batch 64, a4): the key of
# its kernel rows (see main's ``case``).
ALEXNET_B64 = ("alexnet", BATCH, "elp_bsd_a4")


def gemm_shapes(spec) -> list:
    """Each conv/fc GEMM of ``spec``'s forward: ("conv", H = W in, Cin, k, stride,
    Cout) or ("fc", K, N), in layer order (SAME convs, VALID pools)."""
    from repro_torch.models import cnn

    hw, ch, flat, out = spec.input_hw, spec.input_ch, None, []
    for layer in spec.layers:
        if isinstance(layer, cnn.Conv):
            out.append(("conv", hw, ch, layer.k, layer.stride, layer.ch))
            hw, ch = -(-hw // layer.stride), layer.ch
        elif isinstance(layer, cnn.Pool):
            hw = (hw - layer.k) // layer.stride + 1
        else:
            out.append(("fc", flat if flat is not None else hw * hw * ch, layer.out))
            flat = layer.out
    return out


def per_forward(spec) -> dict:
    """Launches of one packed forward of ``spec`` at the eval batch: every conv on
    the tiled bf16x3 route (M = 128 * Ho * Wo > 256), every fc on the decode-step
    bf16x3 route (M = 128)."""
    kinds = [g[0] for g in gemm_shapes(spec)]
    return {"elp_bsd_matmul/bf16x3": kinds.count("conv"),
            "fused_decode_matmul/bf16x3": kinds.count("fc")}


def _times(launches: dict, n: int) -> tuple:
    return _expected({k: v * n for k, v in launches.items()})


def bf16x3_k_sweep(torch, dev, gen, failures) -> None:
    """Both bf16x3 routes' distance from the product summed in float64, at each K
    of BF16X3_KS, for the kernel (three terms) and the plain arithmetic with 1, 2
    and 3 bf16 terms of x and in float32 (cuBLAS, no TF32); a4 nibble codes,
    N = 256, M = 2048 (tiled) and 64 (decode step), x zero-mean and post-ReLU
    (products that do not cancel in sign, as an fc layer gets them). Gated: the
    kernel under BF16X3_K_GATE of the REL_TOL limit at every K (both routes'
    float32 register sums; a whole K split summed on the tensor cores read 1.04
    at K = 25088 on the tiled route, 0.756 on the decode-step route at VGG16's
    fc0), and the one-term control over 1, so the gate sees a real fault."""
    from repro_torch.core.elp_bsd import PRESET_FORMATS
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul, elp_bsd_matmul_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul
    from repro_torch.kernels.ref import elp_bsd_matmul_bf16x3

    fmt = PRESET_FORMATS["elp_bsd_a4"]
    n = 256
    for kdim in BF16X3_KS:
        codes = torch.randint(0, 256, ((kdim + 1) // 2, n), device=dev, generator=gen,
                              dtype=torch.uint8)
        sf = torch.tensor([1.0 / kdim ** 0.5], device=dev)
        for name, kernel, m, x_kind in (
                ("elp_bsd_matmul/bf16x3", elp_bsd_matmul, 2048, "normal"),
                ("elp_bsd_matmul/bf16x3", elp_bsd_matmul, 2048, "relu"),
                ("fused_decode_matmul/bf16x3", fused_decode_matmul, 64, "normal"),
                ("fused_decode_matmul/bf16x3", fused_decode_matmul, 64, "relu")):
            x = torch.randn(m, kdim, device=dev, generator=gen)
            if x_kind == "relu":
                x = torch.relu(x)
            want = _f64_sum(x, codes, sf, fmt, nibble=True)
            limit = REL_TOL * want.abs().max().item()
            dist = {"kernel": kernel(x, codes, sf, fmt, nibble=True)}
            for t in (1, 2, 3):
                dist[f"{t} terms"] = elp_bsd_matmul_bf16x3(x, codes, sf, fmt, nibble=True,
                                                           terms=t)
            dist["float32"] = elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=True)
            ratio = {k: (v - want).abs().max().item() / limit for k, v in dist.items()}
            print(f"[bf16x3-k] {name} K={kdim} M={m} N={n} x {x_kind}: max |out - f64| / limit ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in ratio.items())
                  + f"); limit {REL_TOL:g} * max|f64| = {limit:.3e}; gate kernel < "
                  f"{BF16X3_K_GATE:g}, one term > 1")
            if not ratio["kernel"] < BF16X3_K_GATE:
                failures.append(f"[bf16x3-k] {name} K={kdim} x {x_kind}: kernel "
                                f"{ratio['kernel']:.4f} of the limit")
            if not ratio["1 terms"] > 1:
                failures.append(f"[bf16x3-k] {name} K={kdim} x {x_kind}: the one-term control reads "
                                f"{ratio['1 terms']:.4f}, under the limit")
            del x, want, dist


def mini_phase(torch, dev, failures, forwards) -> tuple:
    """Train both mini CNNs on the card at the reference's budget, then Fig. 15(a)
    (ALEXNET_MINI) and Fig. 15(b) (both), the latter also on the CPU with the same
    weights. Returns (trained weights on the card, launches of the packed runs)."""
    from repro_torch import api
    from repro_torch.experiments import common
    from repro_torch.experiments import fig15a_error_comp as fig15a
    from repro_torch.experiments import fig15b_accuracy_pdp as fig15b
    from repro_torch.models import cnn

    trained, launches = {}, (0,) * len(KERNEL_ROUTES)
    for spec_name in MINI_SPECS:
        spec = getattr(cnn, spec_name)
        t0 = time.perf_counter()
        trained[spec_name] = common.train_mini_cnn(spec, device=dev, cache=False)
        torch.cuda.synchronize()
        base = common.make_eval_fn(spec, device=dev)(trained[spec_name], None)
        print(f"[mini] {spec.name}: 1200 momentum-SGD steps at batch {common.BATCH} (lr 2e-2, "
              f"seed 0) on the card in {time.perf_counter() - t0:.1f} s; float eval accuracy "
              f"{base:.4f} ({EVAL_BATCHES}x{EVAL_BATCH} held-out images)")

        # one packed forward at the eval batch: exact launches per route
        qm = api.quantize(spec, trained[spec_name], api.QuantScheme(fmt="elp_bsd_a4"), device=dev)
        x, _ = common.CnnDataset(32, 3, 10, EVAL_BATCH).np_batch(10_000)
        _zero_counts()
        qm.forward(x)
        torch.cuda.synchronize()
        c = _counts()
        forwards[(spec.name, EVAL_BATCH, "elp_bsd_a4")] += 1
        print(f"[mini] {spec.name} launches in one packed forward at batch {EVAL_BATCH}: "
              f"{dict(zip(KERNEL_ROUTES, c))}")
        if c != _times(per_forward(spec), 1):
            failures.append(f"{spec.name} packed forward launches {c}")
        launches = tuple(a + b for a, b in zip(launches, c))

        # Fig. 15(b) on the card (kernels), counted, and on the CPU (plain versions)
        t0 = time.perf_counter()
        _zero_counts()
        rows = fig15b.run(spec, FIG15B_ACT_BITS, params=trained[spec_name], device=dev)
        torch.cuda.synchronize()
        c = _counts()
        card_s = time.perf_counter() - t0
        n_fwd = len(FIG15B_ACT_BITS) * EVAL_BATCHES
        for fmt in FMT_NAMES:
            forwards[(spec.name, EVAL_BATCH, fmt)] += n_fwd
        want = _times(per_forward(spec), len(FMT_NAMES) * n_fwd)
        print(f"[mini] {spec.name} fig15b on the card: {card_s:.1f} s; launches "
              f"{dict(zip(KERNEL_ROUTES, c))} (expected {want})")
        if c != want:
            failures.append(f"{spec.name} fig15b launches {c}")
        launches = tuple(a + b for a, b in zip(launches, c))
        t0 = time.perf_counter()
        cpu_rows = fig15b.run(spec, FIG15B_ACT_BITS,
                              params={k: v.cpu() for k, v in trained[spec_name].items()},
                              device="cpu")
        worst = max(abs(a["accuracy"] - b["accuracy"]) for a, b in zip(rows, cpu_rows))
        print(f"[mini] {spec.name} fig15b on the CPU (plain versions, same weights): "
              f"{time.perf_counter() - t0:.1f} s; card vs CPU accuracy, largest difference over "
              f"the {len(FMT_NAMES) * len(FIG15B_ACT_BITS)} cells {worst:.4f} (limit {AC})")
        for a, b in zip(rows, cpu_rows, strict=True):
            print(f"[mini] {spec.name} fig15b {a['format']} a{a['act_bits']}: card "
                  f"{a['accuracy']:.4f}, CPU {b['accuracy']:.4f}")
            if abs(a["accuracy"] - b["accuracy"]) > AC:
                failures.append(f"{spec.name} fig15b {a['format']} a{a['act_bits']} card vs CPU")
        print(f"[mini] {spec.name} fig15b rows (card):")
        fig15b.report(rows)
        sys.stdout.flush()

    t0 = time.perf_counter()
    _zero_counts()
    params = trained["ALEXNET_MINI"]
    rows = fig15a.run(cnn.ALEXNET_MINI, params=params, device=dev)
    act = fig15a.run_activation(cnn.ALEXNET_MINI, params=params, device=dev)
    if _counts() != (0,) * len(KERNEL_ROUTES):  # float weights: no packed matmul
        failures.append(f"fig15a launched kernels {_counts()}")
    print(f"[mini] alexnet_mini fig15a on the card ({time.perf_counter() - t0:.1f} s):")
    fig15a.report(rows, act)
    return trained, launches


def quickstart_phase(torch, dev, trained, failures, forwards) -> tuple:
    """The quickstart example's flow (``repro_torch.experiments.quickstart``'s
    ``convert`` and ``round_trip``) on the card and on the CPU: the Sec. V search
    on the trained ALEXNET_MINI, then the packed artifact's eval on the kernels,
    save, load and a bit-identical reloaded forward. Returns launches."""
    from repro_torch.experiments import common, quickstart
    from repro_torch.kernels.ref import unpack_nibbles_k

    spec = quickstart.SPEC
    t0 = time.perf_counter()
    qm = quickstart.convert(trained, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qc = quickstart.convert({k: v.cpu() for k, v in trained.items()}, "cpu")
    cpu_s = time.perf_counter() - t0
    r, rc = qm.report, qc.report
    differ = sum(int((unpack_nibbles_k(v.codes.cpu()) != unpack_nibbles_k(qc.params[k].codes))
                     .sum()) for k, v in qm.params.items() if k.endswith("_w"))
    n_codes = sum(v.shape[0] * v.shape[1] for k, v in qm.params.items() if k.endswith("_w"))
    print(f"[quickstart] api.quantize(alexnet_mini, eval_fn) card {card_s:.2f} s, CPU "
          f"{cpu_s:.2f} s: CBW_A card {r.act_bits}, CPU {rc.act_bits}; baseline accuracy card "
          f"{r.baseline_accuracy:.4f} CPU {rc.baseline_accuracy:.4f}; float-twin accuracy card "
          f"{r.accuracy:.4f} CPU {rc.accuracy:.4f}; codes differing card vs CPU {differ} of "
          f"{n_codes}; compression {r.compression:.2f}x ({r.raw_bytes} -> {r.packed_bytes} B, "
          f"bit-packed {r.encoded_bytes} B); Table II energy {r.energy_nj / 1e3:.3f} uJ")
    if r.act_bits != rc.act_bits:
        failures.append(f"quickstart CBW_A card {r.act_bits} vs CPU {rc.act_bits}")

    eval_fn = common.make_eval_fn(spec, device=dev)
    x = quickstart.eval_batch(EVAL_BATCH, index=10_000, device=dev)
    _zero_counts()
    packed_acc = eval_fn(qm.params, r.act_bits)
    path = os.path.join(ROOT, "build", "chip_smoke", "alexnet_mini_elp4")
    _, _, same = quickstart.round_trip(qm, x, path, dev)
    torch.cuda.synchronize()
    c = _counts()
    forwards[(spec.name, EVAL_BATCH, "elp_bsd_a4")] += EVAL_BATCHES + 2
    want = _times(per_forward(spec), EVAL_BATCHES + 2)
    print(f"[quickstart] packed accuracy on the kernels {packed_acc:.4f} (act bits {r.act_bits}; "
          f"float twin {r.accuracy:.4f}); reloaded forward bit-identical {same}; launches "
          f"{dict(zip(KERNEL_ROUTES, c))} (expected {want})")
    if not same:
        failures.append("quickstart save/load forward drifted")
    if abs(packed_acc - r.accuracy) > AC:
        failures.append(f"quickstart packed accuracy {packed_acc} vs float twin {r.accuracy}")
    if c != want:
        failures.append(f"quickstart launches {c}")
    shutil.rmtree(path)
    return c


def full_search_phase(torch, dev, failures, forwards) -> tuple:
    """The Sec. V search on full-width ALEXNET with seeded weights. Its eval_fn is
    top-1 agreement with the float model's argmax on the reference's 8 eval
    batches of 128 (CnnDataset(224, 3, 10, 128), steps 10000-10007): the task's
    labels mean nothing to untrained weights. Returns launches."""
    from repro_torch import api
    from repro_torch.data.pipeline import CnnDataset
    from repro_torch.models import cnn

    spec = cnn.ALEXNET
    t0 = time.perf_counter()
    params = cnn.init_params(spec, seed=0, device=dev)
    ds = CnnDataset(224, 3, 10, EVAL_BATCH)
    xs = [torch.from_numpy(ds.np_batch(10_000 + i)[0]).to(dev) for i in range(EVAL_BATCHES)]
    with torch.no_grad():
        ref = [torch.argmax(cnn.forward(params, spec, x), -1) for x in xs]
    torch.cuda.synchronize()
    print(f"[full] seeded ALEXNET params, {EVAL_BATCHES}x{EVAL_BATCH} images and their float "
          f"argmax in {time.perf_counter() - t0:.1f} s")
    n_evals = []

    def agreement(p, act_quant):
        n_evals.append(act_quant)
        with torch.no_grad():
            acc = [torch.mean((torch.argmax(cnn.forward(p, spec, x, act_bits=act_quant), -1)
                               == y).to(torch.float32)) for x, y in zip(xs, ref)]
        return float(torch.stack(acc).mean())

    scheme = api.QuantScheme(fmt="elp_bsd_a4", act="dynamic", ac=AC, bw_max=8, bw_min=4)
    t0 = time.perf_counter()
    qm = api.quantize(spec, params, scheme, eval_fn=agreement, device=dev)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    r = qm.report
    print(f"[full] api.quantize(ALEXNET, eval_fn) {search_s:.2f} s with {len(n_evals)} "
          f"evaluations (act_quant {n_evals}): CBW_A {r.act_bits}, baseline agreement "
          f"{r.baseline_accuracy:.4f}, float-twin agreement {r.accuracy:.4f}")
    del params
    torch.cuda.empty_cache()
    _zero_counts()
    packed = agreement(qm.params, r.act_bits)
    first = qm.forward(xs[0])
    path = os.path.join(ROOT, "build", "chip_smoke", "alexnet_elp4")
    t0 = time.perf_counter()
    qm.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = api.load(path, device=dev)
    load_s = time.perf_counter() - t0
    again = back.forward(xs[0])
    torch.cuda.synchronize()
    c = _counts()
    forwards[(spec.name, EVAL_BATCH, "elp_bsd_a4")] += EVAL_BATCHES + 2
    want = _times(per_forward(spec), EVAL_BATCHES + 2)
    same = bool(torch.equal(first, again))
    disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    print(f"[full] packed agreement on the kernels {packed:.4f} (float twin {r.accuracy:.4f}, "
          f"limit {AC}); reloaded forward bit-identical {same}; save {save_s:.2f} s, load "
          f"{load_s:.2f} s; bytes: raw {r.raw_bytes}, packed {r.packed_bytes}, bit-packed "
          f"{r.encoded_bytes}, artifact on disk {disk}; launches {dict(zip(KERNEL_ROUTES, c))} "
          f"(expected {want})")
    if not same:
        failures.append("full-width save/load forward drifted")
    if abs(packed - r.accuracy) > AC:
        failures.append(f"full-width packed agreement {packed} vs float twin {r.accuracy}")
    if c != want:
        failures.append(f"full-width launches {c}")
    shutil.rmtree(path)
    return c


# The paper's second network at full width: VGG16 (13 convs, 3 fc layers;
# 15.5 GMAC an image), seeded weights, a4 nibble codes, static 8-bit
# activations calibrated on VGG_CALIB seeded images, batch 64 through
# api.quantize, as the AlexNet path. Card against CPU at batch VGG_CPU_BATCH
# (the full forward on the host's CPU is too slow for the script).
VGG_CALIB = (2, 8)
VGG_CPU_BATCH = 2


def vgg16_phase(torch, dev, failures, rows) -> dict:
    """Full-width VGG16 on the card. Returns the launches of its counted forward."""
    import torch.nn.functional as F

    from repro_torch import api
    from repro_torch.device import full_f32
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv import pad_nhwc
    from repro_torch.models import cnn

    spec = cnn.VGG16
    hw, n_classes = spec.input_hw, spec.layers[-1].out
    t0 = time.perf_counter()
    params = cnn.init_params(spec, seed=0, device=dev)
    img_gen = torch.Generator(device=dev).manual_seed(2)
    calib = torch.randn(*VGG_CALIB, hw, hw, spec.input_ch, device=dev, generator=img_gen)
    batch = torch.randn(BATCH, hw, hw, spec.input_ch, device=dev, generator=img_gen)
    torch.cuda.synchronize()
    print(f"[vgg16] seeded VGG16 params ({sum(v.numel() for v in params.values())} weights) and "
          f"images in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qm = api.quantize(spec, params, api.QuantScheme(fmt="elp_bsd_a4", act="static", act_bits=8),
                      calib_data=calib, device=dev)
    torch.cuda.synchronize()
    print(f"[vgg16] api.quantize (calibrate {VGG_CALIB[0]}x{VGG_CALIB[1]} images, fold, pack): "
          f"{time.perf_counter() - t0:.2f} s; packed {qm.report.packed_bytes} B (raw "
          f"{qm.report.raw_bytes} B, {qm.report.compression:.2f}x), Table II energy "
          f"{qm.report.energy_nj:.4g} nJ")
    del params, calib
    torch.cuda.empty_cache()

    # One counted forward, its kernel shapes tapped, each conv's input kept for
    # the cuDNN yardstick (keyed by its im2col shape).
    conv_inputs = {}
    real_conv = cnn.quantized_conv2d

    def keep_conv_input(x, pw, *, stride=1, **kw):
        kh, kw_, cin, cout = pw.source_shape
        b, h, w_, _ = x.shape
        key = (b * (-(-h // stride)) * (-(-w_ // stride)), kh * kw_ * cin, cout)
        conv_inputs.setdefault(key, (x.clone(), pw.source_shape, stride))
        return real_conv(x, pw, stride=stride, **kw)

    tap = KernelTap()
    cnn.quantized_conv2d = keep_conv_input
    try:
        _zero_counts()
        with tap:
            logits = qm.forward(batch)
        torch.cuda.synchronize()
        c = _counts()
    finally:
        cnn.quantized_conv2d = real_conv
    n_conv = sum(isinstance(layer, cnn.Conv) for layer in spec.layers)
    n_fc = sum(isinstance(layer, cnn.Fc) for layer in spec.layers)
    want = _expected({"elp_bsd_matmul/bf16x3": n_conv, "fused_decode_matmul/bf16x3": n_fc})
    print(f"[vgg16] launches in one forward at batch {BATCH}: {dict(zip(KERNEL_ROUTES, c))} "
          f"(expected {n_conv} tiled + {n_fc} decode-step bf16x3)")
    if c != want:
        failures.append(f"vgg16 launches {c}")
    if tuple(logits.shape) != (BATCH, n_classes) or not bool(torch.isfinite(logits).all()):
        failures.append(f"vgg16 logits shape {tuple(logits.shape)} or non-finite values")

    def cudnn_conv(x, wq):
        hit = conv_inputs.get((x.shape[0], x.shape[1], wq.shape[1]))
        if hit is None:
            return None
        img, (kh, kw_, cin, cout), stride = hit
        xi = pad_nhwc(img, kh, kw_, stride, "SAME").permute(0, 3, 1, 2).contiguous()
        wc = wq.reshape(kh, kw_, cin, cout).permute(3, 2, 0, 1).contiguous()
        return lambda: F.conv2d(xi, wc, stride=stride).permute(0, 2, 3, 1)

    _hold_f64(torch, tap, failures)
    with full_f32():
        hold_tapped(torch, dev, "vgg16 forward", tap, rows, failures, library_for=cudnn_conv)
    conv_inputs.clear()
    torch.cuda.empty_cache()

    fwd = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        t0 = time.perf_counter()
        qm.forward(batch)
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print(f"[vgg16] forward at batch {BATCH}: median {statistics.median(fwd):.2f} ms (runs "
          f"{[round(t, 2) for t in fwd]}), max_memory_allocated {peak} B")

    t0 = time.perf_counter()
    qm_cpu = qm.to("cpu")
    few = batch[:VGG_CPU_BATCH].cpu()
    with torch.no_grad():
        float_card = cnn.forward(qm.params, spec, batch[:VGG_CPU_BATCH]).cpu()
        float_cpu = cnn.forward(qm_cpu.params, spec, few)
    pairs = [("static 8-bit activations", logits[:VGG_CPU_BATCH].cpu(), qm_cpu.forward(few),
              STATIC_LOGIT_REL_TOL),
             ("float activations", float_card, float_cpu, FLOAT_LOGIT_REL_TOL)]
    for label, card, cpu, rel in pairs:
        diff = (card - cpu).abs().max().item()
        limit = rel * cpu.abs().max().item()
        same_argmax = bool((card.argmax(-1) == cpu.argmax(-1)).all())
        print(f"[vgg16] card vs CPU logits, {label}, same packed params, {VGG_CPU_BATCH} images: "
              f"max_abs_diff {diff:.3e} ({diff / cpu.abs().max().item():.3e} of max |logit|, "
              f"limit {rel:g}), argmax identical {same_argmax}")
        if not (diff <= limit and same_argmax):
            failures.append(f"vgg16 card logits ({label}) differ from the CPU port")
    print(f"[vgg16] CPU reference runs took {time.perf_counter() - t0:.1f} s")
    del qm, qm_cpu, batch, logits
    torch.cuda.empty_cache()
    return dict(zip(KERNEL_ROUTES, c))


def _hold_f64(torch, tap, failures) -> None:
    """Each tapped matmul's output from the run, and its plain version, against
    the product summed in float64; the kernel gated at BF16X3_K_GATE of the
    REL_TOL limit, as in [bf16x3-k]."""
    for rec in sorted(tap.calls.values(), key=lambda r: r["args"][0].shape):
        _hold_one_f64(torch, rec, failures)


def _hold_one_f64(torch, rec, failures) -> None:
    """One tapped matmul against float64, in row chunks (VGG16's conv1_2 patches
    are 7.4 GB in float32)."""
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain

    x, codes, sf, fmt = rec["args"]
    nibble = rec["kw"]["nibble"]
    err, top = {"kernel": 0.0, "plain": 0.0}, 0.0
    for i in range(0, x.shape[0], 1 << 18):
        rows_i = slice(i, i + (1 << 18))
        want = _f64_sum(x[rows_i], codes, sf, fmt, nibble=nibble, out_dtype=torch.float32)
        plain = elp_bsd_matmul_plain(x[rows_i], codes, sf, fmt, nibble=nibble,
                                     out_dtype=torch.float32)
        top = max(top, want.abs().max().item())
        for k, got in (("kernel", rec["out"][rows_i]), ("plain", plain)):
            err[k] = max(err[k], (got.float() - want).abs().max().item())
    ratio = {k: v / (REL_TOL * top) for k, v in err.items()}
    print(f"[vgg16] {rec['name']} M={x.shape[0]} K={x.shape[1]} N={codes.shape[1]}: max |out - "
          f"f64| / limit: kernel {ratio['kernel']:.4f} (gate {BF16X3_K_GATE:g}), plain "
          f"{ratio['plain']:.4f} (reported)")
    if not ratio["kernel"] < BF16X3_K_GATE:
        failures.append(f"vgg16 {rec['name']} K={x.shape[1]}: kernel {ratio['kernel']:.4f} of "
                        "the limit against float64")


def paper_results_phase(torch, dev, trained, failures, forwards) -> tuple:
    """The paper's remaining results on the minis that mini_phase trained on the
    card: Sec. VI-D (``caxcnn_compare``, also on the CPU with the same weights),
    dynamic against static activations (``calib_bench``, packed c6 forwards on
    the kernels, counted) and Table II (``table2_energy``), each printing the
    JAX scripts' ``name,us,derived`` rows. Returns the launches."""
    from repro_torch.experiments import calib_bench, caxcnn_compare, table2_energy
    from repro_torch.models import cnn

    t0 = time.perf_counter()
    params = trained["ALEXNET_MINI"]
    _zero_counts()
    card = caxcnn_compare.run(cnn.ALEXNET_MINI, params=params, device=dev)
    torch.cuda.synchronize()
    if _counts() != (0,) * len(KERNEL_ROUTES):  # float weights: no packed matmul
        failures.append(f"caxcnn_compare launched kernels {_counts()}")
    cpu = caxcnn_compare.run(cnn.ALEXNET_MINI, params={k: v.cpu() for k, v in params.items()},
                             device="cpu")
    worst = max(abs(card[k] - cpu[k]) for k in ("baseline", "caxcnn_5b", "conlocnn_4b"))
    print(f"[paper] caxcnn_compare on the card ({time.perf_counter() - t0:.1f} s with the CPU "
          f"run); card vs CPU accuracy, largest difference {worst:.4f} (limit {AC}); logit MSE "
          f"card {card['mse_cax']:.6g} / {card['mse_conlo']:.6g}, CPU {cpu['mse_cax']:.6g} / "
          f"{cpu['mse_conlo']:.6g}")
    if worst > AC:
        failures.append(f"caxcnn_compare card vs CPU accuracy {worst}")
    caxcnn_compare.report(card)

    launches = (0,) * len(KERNEL_ROUTES)
    for spec_name in MINI_SPECS:
        spec = getattr(cnn, spec_name)
        t0 = time.perf_counter()
        _zero_counts()
        r = calib_bench.run(spec, params=trained[spec_name], device=dev)
        torch.cuda.synchronize()
        c = _counts()
        # 3 forwards (float, dynamic, static) x (1 warm-up + 5 timed), then the
        # dynamic and static forwards under the range-reduction counter
        n_fwd = 3 * 6 + 2
        forwards[(spec.name, EVAL_BATCH, "elp_bsd_c6")] += n_fwd
        want = _times(per_forward(spec), n_fwd)
        n_conv = sum(isinstance(layer, cnn.Conv) for layer in spec.layers)
        n_fc = sum(isinstance(layer, cnn.Fc) for layer in spec.layers)
        sites = 1 + n_conv + n_fc - 1
        print(f"[paper] calib_bench {spec.name} on the card: {time.perf_counter() - t0:.1f} s; "
              f"range reductions static {r['reduce_max_static']} (must be 0), dynamic "
              f"{r['reduce_max_dynamic']} (one a site: {sites}); launches "
              f"{dict(zip(KERNEL_ROUTES, c))} (expected {want})")
        if r["reduce_max_static"] != 0 or r["reduce_max_dynamic"] != sites:
            failures.append(f"calib_bench {spec.name} range reductions {r['reduce_max_static']} / "
                            f"{r['reduce_max_dynamic']}")
        if c != want:
            failures.append(f"calib_bench {spec.name} launches {c}")
        launches = tuple(a + b for a, b in zip(launches, c))
        calib_bench.report(spec, r)
    table2_energy.main()
    sys.stdout.flush()
    return launches


# LM training on one card. (1) lm-100m, the config of the JAX package's
# examples/train_lm.py (float32, 16 layers, d 512, vocab 32000, about 96 M
# parameters) at batch TRAIN_BATCH x TRAIN_SEQ, remat on: a straight run of
# TRAIN_STEPS steps; a run of TRAIN_RESUME_AT steps with a checkpoint every
# TRAIN_CKPT_EVERY, then train(steps=TRAIN_STEPS) on the same directory, its
# steps held to the straight run's losses (TRAIN_RESUME_REL_TOL); then each
# gradient codec for TRAIN_COMPRESS_STEPS steps. (2) lm-ptq, the first
# TRAIN_CPU_STEPS steps on the card against the port on the host's CPU, TF32
# off. (3) qwen3-8b at full width, depth cut to TRAIN_QWEN_LAYERS of 36 (full
# depth's bf16 params, float32 masters and moments and bf16 gradients are
# about 131 GB, over one 80 GB card), bf16 params, remat on.
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_CKPT_EVERY = 80, 60, 20
TRAIN_COMPRESS_STEPS = 10
TRAIN_RESUME_REL_TOL = 1e-6
TRAIN_CPU_STEPS = 3
TRAIN_CPU_REL_TOL = 1e-4
TRAIN_QWEN_LAYERS, TRAIN_QWEN_STEPS = 4, 6


def _no_kernel_launches(label, failures) -> None:
    """The training forward and backward run no kernel (the flash counter among them)."""
    c = dict(zip(KERNEL_ROUTES, _counts()))
    print(f"[train] {label}: kernel launches during training {sum(c.values())} (flash "
          f"{c['flash_attention/wgmma'] + c['flash_attention/f32']}; must be 0)")
    if any(c.values()):
        failures.append(f"{label}: kernels launched during training {c}")


def train_phase(torch, dev, failures) -> None:
    """The three training runs above."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.device import full_f32
    from repro_torch.experiments import lm_ptq, train_lm
    from repro_torch.kernels.ops import tree_leaves, tree_map
    from repro_torch.models import get_model
    from repro_torch.obs.metrics import Registry
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainSetup, make_train_step, train

    # (1) lm-100m: straight, checkpointed and resumed, compressed
    cfg = train_lm.CFG
    setup = TrainSetup(cfg=cfg, lr_peak=6e-4, warmup=50, total_steps=TRAIN_STEPS, remat=True)
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=20, device=dev,
              log_fn=lambda line: print(f"[train] lm-100m {line}"))
    reg = Registry(enabled=True)
    _zero_counts()
    t0 = time.perf_counter()
    straight = train(setup, steps=TRAIN_STEPS, metrics=reg, **kw)
    wall = time.perf_counter() - t0
    want = straight["losses"]
    hist, rep = reg.histogram("train.step_s"), straight["straggler_report"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    first10, last10 = statistics.mean(want[:10]), statistics.mean(want[-10:])
    n_params = sum(t.numel() for t in tree_leaves(straight["params"]))
    print(f"[train] lm-100m ({n_params} parameters, float32, remat) {TRAIN_STEPS} steps at "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} in {wall:.1f} s: step median {rep['median_s'] * 1e3:.2f} ms "
          f"(last {min(TRAIN_STEPS, 50)}), mean {hist.mean * 1e3:.2f} ms, max "
          f"{rep['max_s'] * 1e3:.2f} ms; {tokens / rep['median_s']:.0f} tokens/s at the median; "
          f"loss first10 {first10:.4f} last10 {last10:.4f}; obs train.steps_total "
          f"{reg.counter('train.steps_total').value:.0f}, train.lr {reg.gauge('train.lr').value:.3g}")
    _no_kernel_launches("lm-100m straight", failures)
    if not last10 < first10 or not all(math.isfinite(v) for v in want):
        failures.append(f"lm-100m loss did not fall: {first10} -> {last10}")
    del straight
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckpt:
        _zero_counts()
        first = train(setup, steps=TRAIN_RESUME_AT, ckpt_dir=ckpt, ckpt_every=TRAIN_CKPT_EVERY,
                      **kw)
        resumed = train(setup, steps=TRAIN_STEPS, ckpt_dir=ckpt, ckpt_every=TRAIN_CKPT_EVERY,
                        **kw)
        _no_kernel_launches("lm-100m checkpointed and resumed", failures)
    before = max(abs(a - b) / abs(b) for a, b in zip(first["losses"], want[:TRAIN_RESUME_AT]))
    after = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], want[TRAIN_RESUME_AT:]))
    print(f"[train] lm-100m resume: {len(first['losses'])} steps with a checkpoint every "
          f"{TRAIN_CKPT_EVERY}, then train(steps={TRAIN_STEPS}) ran {len(resumed['losses'])} "
          f"steps from step {TRAIN_STEPS - len(resumed['losses'])}; largest relative loss "
          f"difference to the straight run {before:.3e} before the checkpoint, {after:.3e} after "
          f"(limit {TRAIN_RESUME_REL_TOL:g})")
    if len(resumed["losses"]) != TRAIN_STEPS - TRAIN_RESUME_AT or not after <= TRAIN_RESUME_REL_TOL:
        failures.append(f"lm-100m resume: {len(resumed['losses'])} steps, {after:.3e}")
    del first, resumed
    for codec in ("int8", "elp4"):
        _zero_counts()
        out = train(dataclasses.replace(setup, compress=codec), steps=TRAIN_COMPRESS_STEPS,
                    **{**kw, "log_every": TRAIN_STEPS})
        losses = out["losses"]
        print(f"[train] lm-100m compress={codec}: {len(losses)} steps, losses {losses[0]:.4f} .. "
              f"{losses[-1]:.4f}, step median {out['straggler_report']['median_s'] * 1e3:.2f} ms")
        _no_kernel_launches(f"lm-100m compress={codec}", failures)
        if not all(math.isfinite(v) for v in losses):
            failures.append(f"lm-100m compress={codec}: non-finite loss")
        del out
    torch.cuda.empty_cache()

    # (2) lm-ptq: the first steps on the card against the host's CPU, TF32 off.
    # AdamW's first steps move a weight by about lr * g / (|g| + eps); at the
    # default eps of 1e-8 a gradient of that size turns float32 noise into a
    # difference of order lr, so these steps run at eps 1e-3.
    cfg = lm_ptq.CFG
    setup = TrainSetup(cfg=cfg, adamw_cfg=adamw.AdamWConfig(eps=1e-3), lr_peak=3e-3, warmup=0,
                       total_steps=200, remat=False)
    ds = LmDataset(cfg, seq_len=64, batch=16, seed=0)
    init = get_model(cfg).init_params(cfg, 0, device="cpu")
    runs = {}
    _zero_counts()
    with full_f32():
        for where in ("cpu", dev):
            p = tree_map(lambda t: t.to(where), init)
            opt, step, losses = adamw.init_state(p), make_train_step(setup), []
            for i in range(TRAIN_CPU_STEPS):
                p, opt, _, m = step(p, opt, None, shard_batch(ds.np_batch(i), device=where))
                losses.append(float(m["loss"]))
            runs[str(where)] = (losses, p)
    _no_kernel_launches("lm-ptq card vs CPU", failures)
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    w_rel = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    print(f"[train] lm-ptq card vs CPU, {TRAIN_CPU_STEPS} steps (TF32 off, eps 1e-3): losses card "
          f"{[round(v, 6) for v in lg]}, CPU {[round(v, 6) for v in lc]}; largest relative loss "
          f"difference {loss_rel:.3e}, parameters after the last step {w_rel:.3e} of each leaf's "
          f"max |w| (limit {TRAIN_CPU_REL_TOL:g} for both)")
    if not (loss_rel <= TRAIN_CPU_REL_TOL and w_rel <= TRAIN_CPU_REL_TOL):
        failures.append(f"lm-ptq train card vs CPU: loss {loss_rel:.3e}, params {w_rel:.3e}")
    del runs, pc, pg

    # (3) qwen3-8b at full width, TRAIN_QWEN_LAYERS layers, bf16 params
    cfg = dataclasses.replace(get_config("qwen3_8b"), n_layers=TRAIN_QWEN_LAYERS)
    setup = TrainSetup(cfg=cfg, lr_peak=3e-4, warmup=2, total_steps=TRAIN_QWEN_STEPS, remat=True)
    t0 = time.perf_counter()
    params = get_model(cfg).init_params(cfg, 0, device=dev)
    opt = adamw.init_state(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] qwen3-8b, {TRAIN_QWEN_LAYERS} of 36 layers: {n_params} parameters (bf16), "
          f"float32 masters and moments, in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated()} B allocated")
    ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    step = make_train_step(setup)
    times, losses, gnorms = [], [], []
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_QWEN_STEPS):
        batch = shard_batch(ds.np_batch(i), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, m = step(params, opt, None, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    print(f"[train] qwen3-8b {TRAIN_QWEN_LAYERS} layers, {TRAIN_QWEN_STEPS} steps at "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}, remat: step ms {[round(t, 1) for t in times]}, median of "
          f"the last {TRAIN_QWEN_STEPS - 1} {med:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} "
          f"tokens/s; losses {[round(v, 4) for v in losses]}; grad norms "
          f"{[round(v, 3) for v in gnorms]}; max_memory_allocated {peak} B")
    _no_kernel_launches("qwen3-8b", failures)
    if not all(math.isfinite(v) for v in losses + gnorms):
        failures.append("qwen3-8b training: non-finite loss or grad norm")
    del params, opt, step
    torch.cuda.empty_cache()


def lm_ptq_phase(torch, dev, failures) -> None:
    """``lm_ptq`` on the card as the script runs it (200 training steps), its rows."""
    from repro_torch.experiments import lm_ptq

    t0 = time.perf_counter()
    _zero_counts()
    base, out = lm_ptq.run(device=dev)
    torch.cuda.synchronize()
    print(f"[lm_ptq] trained {lm_ptq.STEPS} steps and quantized on the card in "
          f"{time.perf_counter() - t0:.1f} s; float eval loss {base:.4f}")
    _no_kernel_launches("lm_ptq", failures)
    losses = [base] + [v for r in out.values() for v in r.values()]
    if not all(math.isfinite(v) for v in losses):
        failures.append("lm_ptq: non-finite eval loss")
    lm_ptq.report(base, out)


# -- the mesh phase: the mesh layer on a one-rank NCCL group -----------------
MESH_REQUESTS = 8  # (a): the first 8 of the engine phase's requests, into 8 slots
MESH_MOE_NEW = 4  # (b): olmoe pays its per-call expert dequantize at every step
MESH_MOE_TOKENS = 512  # (b): the float64 control over the first 4 prompts' tokens
# (c): lm-100m steps and the checkpoint's step; the script's time limit, not the
# checks, sets them
MESH_TRAIN_STEPS, MESH_TRAIN_CKPT = 6, 3
FLASH_DECODE_REL_TOL = 1e-5
MESH_COLLECTIVE_N = 1 << 24


def _issued() -> dict:
    from repro_torch.runtime import collectives

    return dict(collectives.ISSUED)


def _mesh_report(report, label, t0, launches=None) -> None:
    """Record (and print) one part's collectives by kind, launches and seconds."""
    report[label] = {"issued": _issued(), "launches": dict(launches or {}),
                     "s": time.perf_counter() - t0}
    print(f"[mesh] {label}: collectives issued {report[label]['issued']}, "
          f"{report[label]['s']:.1f} s")


def mesh_serve_phase(torch, dev, qm, cfg, calib, failures, mesh, report) -> None:
    """(a) qwen3-8b (the LM phase's packed a4, static 8-bit model) on the engine
    with ``mesh`` and ``flash_decode=True``, dense bf16 and paged int8 caches, on
    the first MESH_REQUESTS engine requests, each beside the meshless engine on
    the same requests: launches exact per model call and equal to the meshless
    run's, the meshed tokens under the teacher-forced gate of the LM phase, and
    ``flash_decode_attention`` held against ``attention_dot`` in float32 on the
    run's own first decode-step query and cache."""
    import contextlib

    import repro_torch.models.transformer as transformer
    import repro_torch.serve.engine as engine_mod
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.models.flash_decode import flash_decode_attention
    from repro_torch.models.layers import attention_dot, repeat_kv
    from repro_torch.runtime import collectives

    reqs = engine_requests(cfg.vocab)[:MESH_REQUESTS]
    scales = calibrate_kv_cache(qm.params, cfg, calib)
    geom = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN)
    first = []
    real_fd = transformer.flash_decode_attention

    def tapped_fd(q, k, v, pos, **kw):
        if not first and q.shape[1] == 1:
            first.append((q.clone(), k.clone(), v.clone(), pos, kw))
        return real_fd(q, k, v, pos, **kw)

    for label, paged in (("dense", {}), ("paged int8", dict(kv_cache="paged",
                                                           page_size=ENGINE_PAGE,
                                                           kv_scales=scales))):
        runs = {}
        for meshed in (False, True):
            t0 = time.perf_counter()
            collectives.reset()
            transformer.flash_decode_attention = tapped_fd
            try:
                outs, eng, launches = _serve_run(
                    torch, f"[mesh] (a) {label}, {'mesh (1, 1), flash-decode' if meshed else 'no mesh'}",
                    lambda reg, log, m=meshed: engine_mod.ServeEngine(
                        cfg, qm.params, metrics=reg, trace=log, mesh=mesh if m else None,
                        flash_decode=m, **geom, **paged).serve(reqs),
                    reqs, failures, contextlib.nullcontext(), paged=bool(paged))
            finally:
                transformer.flash_decode_attention = real_fd
            runs[meshed] = (outs, launches)
            if not meshed:
                plain_hits = eng.stats()["cache"]["prefix_hits"]
            if meshed:
                st = eng.stats()
                print(f"[mesh] (a) {label}: engine mesh {st['mesh']}, moe_impl "
                      f"{eng.setup.pctx().moe_impl}, flash_decode {eng.setup.flash_decode}")
                _mesh_report(report, f"(a) qwen3-8b engine, {label}", t0, launches)
                if not _issued()["all_reduce"]:
                    failures.append(f"[mesh] (a) {label}: no all_reduce issued")
            elif _issued()["all_reduce"]:
                failures.append(f"[mesh] (a) {label}: the meshless run issued collectives")
            del eng
        (plain_outs, plain_l), (mesh_outs, mesh_l) = runs[False], runs[True]
        # the meshless engine's tokens and prefix hits, for the TP phase's part (d)
        os.makedirs(TP_DIR, exist_ok=True)
        torch.save({"outs": [o.tolist() for o in plain_outs], "prefix_hits": plain_hits},
                   os.path.join(TP_DIR, f"qwen3_8b.engine_{'paged' if paged else 'dense'}.pt"))
        same = sum(int((a == b).all()) for a, b in zip(plain_outs, mesh_outs))
        print(f"[mesh] (a) {label}: launches with the mesh {mesh_l}, without {plain_l}; "
              f"requests with tokens identical to the meshless engine's {same}/{len(reqs)}")
        if mesh_l != plain_l:
            failures.append(f"[mesh] (a) {label}: launches {mesh_l} against {plain_l}")
        kv = scales if paged else None
        _engine_held(torch, f"[mesh] (a) {label}, meshed tokens",
                     _forced_pair(torch, qm.params, cfg, reqs, mesh_outs, kv, failures),
                     mesh_outs, failures)
        torch.cuda.empty_cache()
    if not first:
        failures.append("[mesh] (a): flash_decode_attention was never called")
        return
    q, k, v, pos, kw = first[0]
    pctx, window = kw["pctx"], kw.get("window", 0)
    qf, kf, vf = q.float(), k.float(), v.float()
    n_rep = q.shape[2] // k.shape[2]
    fd = lambda: flash_decode_attention(qf, kf, vf, pos, pctx=pctx, window=window)  # noqa: E731
    dot = lambda: attention_dot(qf, repeat_kv(kf, n_rep), repeat_kv(vf, n_rep),  # noqa: E731
                                causal=True, window=window, q_offset=pos)
    got, want = fd(), dot()
    err = (got - want).abs().max().item()
    limit = FLASH_DECODE_REL_TOL * want.abs().max().item()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    fd_ms, dot_ms = timed_ms(fd, torch, flush), timed_ms(dot, torch, flush)
    del flush
    print(f"[mesh] (a) flash_decode_attention on the run's first decode-step q {tuple(q.shape)} "
          f"and cache {tuple(k.shape)} (pos {pos if isinstance(pos, int) else pos.tolist()}), "
          f"float32, against attention_dot: max_abs_err {err:.3e} (limit {limit:.3e}); "
          f"{fd_ms:.4f} ms against {dot_ms:.4f} ms (device time, one layer)")
    if not err <= limit:
        failures.append(f"[mesh] (a) flash_decode_attention vs attention_dot {err:.3e}")


def mesh_moe_phase(torch, dev, qm, cfg, prompts, meshless, failures, mesh, report) -> None:
    """(b) olmoe-1b-7b (the MoE phase's packed model) through ``static_generate``
    with ``mesh`` and ``moe_impl="ep"`` (the expert exchange, capacity factor
    ``cfg.moe_capacity_factor``): launches per prefill and step exact, the
    dropped share of the run's (token, choice) pairs, and on the run's own
    first-layer prefill input ``moe_ep`` held against ``moe_dense`` at a
    capacity that drops nothing and, at the config's, against the partial sum
    of the kept choices, both beside the same products summed in float64."""
    import repro_torch.models.moe as moe_lib
    import repro_torch.serve.engine as engine_mod
    from repro_torch.kernels.ops import dequantize
    from repro_torch.runtime import collectives

    t0 = time.perf_counter()
    setup = engine_mod.ServeSetup(cfg=cfg, mesh=mesh, max_len=LM_PROMPT + MESH_MOE_NEW,
                                  batch=LM_BATCH, moe_impl="ep")
    seen, drops = [], collections.Counter()
    real_ep = moe_lib.moe_ep

    def tapped_ep(p, x2d, cfg_, pctx):
        # the first call's input kept for the holds below; every call's drops counted
        seen.append((p, x2d.clone() if not seen else None, pctx))
        d = moe_lib.ep_dispatch(x2d, p["router"], cfg_, pctx.model_size)["dropped"]
        kind = "prefill" if x2d.shape[0] > LM_BATCH else "decode"
        drops[kind, "dropped"] += d.sum()  # on the device: no sync inside the run
        drops[kind, "pairs"] += d.numel()
        return real_ep(p, x2d, cfg_, pctx)

    collectives.reset()
    _zero_counts()
    moe_lib.moe_ep = tapped_ep
    try:
        new, phases = _phased(torch, lambda: engine_mod.static_generate(
            setup, qm.params, {"tokens": prompts}, MESH_MOE_NEW))
    finally:
        moe_lib.moe_ep = real_ep
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    n_layers = cfg.n_layers
    want = ([("prefill", _expected({"elp_bsd_matmul/wgmma": n_layers * MOE_PER_LAYER,
                                    "flash_attention/wgmma": n_layers}))]
            + [("decode", _expected({"fused_decode_matmul/wgmma": n_layers * MOE_PER_LAYER}))]
            * (MESH_MOE_NEW - 1))
    same = int((new == meshless[:, :MESH_MOE_NEW]).all(dim=1).sum())
    print(f"[mesh] (b) {cfg.name} static_generate, mesh (1, 1), moe_ep at capacity factor "
          f"{cfg.moe_capacity_factor}: {LM_BATCH} x {LM_PROMPT} prompts, {MESH_MOE_NEW} new "
          f"tokens in {time.perf_counter() - t0:.1f} s; launches by phase exact "
          f"{phases == want}; {len(seen)} moe_ep calls; rows identical to the meshless dense "
          f"MoE's first {MESH_MOE_NEW} tokens {same}/{LM_BATCH} (drops change the function)")
    if phases != want:
        failures.append(f"[mesh] (b) launch counts by phase {phases}")
    if (tuple(new.shape) != (LM_BATCH, MESH_MOE_NEW) or int(new.min()) < 0
            or int(new.max()) >= cfg.vocab):
        failures.append(f"[mesh] (b) tokens of shape {tuple(new.shape)} or out of the vocab")
    if len(seen) != n_layers * MESH_MOE_NEW:
        failures.append(f"[mesh] (b) {len(seen)} moe_ep calls, expected {n_layers * MESH_MOE_NEW}")
    _mesh_report(report, f"(b) {cfg.name} static_generate, expert parallel", t0, launches)
    if not _issued()["all_to_all"]:
        failures.append("[mesh] (b): no all_to_all issued")

    # the dropped share: every call's (token, choice) pairs at the config's capacity
    p, x, pctx = seen[0]
    caps = {kind: max(8, math.ceil(t * cfg.topk / cfg.n_experts * cfg.moe_capacity_factor))
            for kind, t in (("prefill", x.shape[0]), ("decode", LM_BATCH))}
    print(f"[mesh] (b) dropped share at capacity factor {cfg.moe_capacity_factor}: "
          + "; ".join(f"{kind} {int(drops[kind, 'dropped']) / drops[kind, 'pairs']:.4f} of "
                      f"{drops[kind, 'pairs']} (token, choice) pairs over {cfg.n_layers} layers"
                      f"{'' if kind == 'prefill' else f' x {MESH_MOE_NEW - 1} steps'} (capacity "
                      f"{caps[kind]} a bucket)" for kind in ("prefill", "decode")))

    # moe_ep against moe_dense on the run's own layer-0 input (its first
    # MESH_MOE_TOKENS tokens), each against the same products in float64
    x = x[:MESH_MOE_TOKENS]
    e, k = cfg.n_experts, cfg.topk
    ample = dataclasses.replace(cfg, moe_capacity_factor=e / k)  # capacity = tokens: no drops
    ep_ample = moe_lib.moe_ep(p, x, ample, pctx).float()
    ep_cfg = moe_lib.moe_ep(p, x, cfg, pctx).float()
    dense = moe_lib.moe_dense(p, x, cfg).float()
    gates, topi = moe_lib.router_gates(x, p["router"], k)
    kept = ~moe_lib.ep_dispatch(x, p["router"], cfg, 1)["dropped"].reshape(-1, k)
    w1, w3, w2 = (dequantize(p[n]).to(x.dtype).double() for n in ("we1", "we3", "we2"))
    xd = x.double()
    full64 = torch.zeros(x.shape, dtype=torch.float64, device=dev)
    part64 = torch.zeros_like(full64)
    mag = torch.zeros(x.shape[0], dtype=torch.float64, device=dev)
    for j in range(e):
        z = (torch.nn.functional.silu(xd @ w1[j]) * (xd @ w3[j])).to(x.dtype).double()
        y = (z @ w2[j]).to(x.dtype).double()  # the expert's output, rounded as the model does
        g = (gates.double() * (topi == j)).sum(1)  # this expert's gate per token (0 if unrouted)
        gk = (gates.double() * ((topi == j) & kept)).sum(1)
        full64 += g[:, None] * y
        part64 += gk[:, None] * y
        mag += g * y.abs().amax(1)
    # ep rounds each of the k gated contributions to bf16 and adds them in bf16:
    # at most k + 2 half-ulp roundings of a partial sum no larger than mag
    limit = (k + 2) * 2.0 ** -9 * mag.max().item()
    reads = {
        "moe_ep, no drops, vs float64": (ep_ample - full64).abs().max().item(),
        "moe_dense vs float64 (the control)": (dense - full64).abs().max().item(),
        f"moe_ep at {cfg.moe_capacity_factor} vs float64 partial sum of kept": (
            ep_cfg - part64).abs().max().item(),
        f"moe_ep at {cfg.moe_capacity_factor} vs float64 full sum (drops must show)": (
            ep_cfg - full64).abs().max().item(),
    }
    print(f"[mesh] (b) layer-0 input, {x.shape[0]} tokens, {int((~kept).sum())} of "
          f"{kept.numel()} choices dropped at {cfg.moe_capacity_factor}: max |diff| "
          + "; ".join(f"{name} {v:.3e}" for name, v in reads.items())
          + f" (limit {limit:.3e} = (k + 2) bf16 half-ulps of the largest gated magnitude; "
          f"ep vs dense {(ep_ample - dense).abs().max().item():.3e})")
    names = list(reads)
    if reads[names[0]] > limit or reads[names[2]] > limit:
        failures.append(f"[mesh] (b) moe_ep against the float64 sums: {reads}")
    if (~kept).any() and reads[names[3]] <= limit:
        failures.append("[mesh] (b) dropped choices do not show against the full sum")
    del seen, w1, w3, w2, full64, part64
    torch.cuda.empty_cache()


def mesh_train_phase(torch, dev, failures, mesh, report) -> list:
    """(c) lm-100m through ``launch/train.py``'s ``train()`` with ``mesh``, with and
    without ``compress="int8"``: the losses equal the meshless run's (limit
    TRAIN_RESUME_REL_TOL); a checkpoint written on the mesh resumed without one
    gives the meshless losses; no kernel launched in any step. Returns the
    meshless run's losses."""
    import tempfile

    from repro_torch.experiments import train_lm
    from repro_torch.runtime import collectives
    from repro_torch.runtime.train_loop import TrainSetup, train

    t0 = time.perf_counter()
    cfg = train_lm.CFG
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=TRAIN_STEPS, device=dev,
              log_fn=lambda line: print(f"[mesh] (c) lm-100m {line}"))
    base = TrainSetup(cfg=cfg, lr_peak=6e-4, warmup=50, total_steps=TRAIN_STEPS, remat=True)
    collectives.reset()
    for compress in (None, "int8"):
        setup = dataclasses.replace(base, compress=compress)
        plain = train(setup, steps=MESH_TRAIN_STEPS, **kw)
        _zero_counts()
        meshed = train(dataclasses.replace(setup, mesh=mesh), steps=MESH_TRAIN_STEPS, **kw)
        _no_kernel_launches(f"mesh lm-100m compress={compress}", failures)
        want, got = plain["losses"], meshed["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[mesh] (c) lm-100m compress={compress}, {MESH_TRAIN_STEPS} steps on the (1, 1) "
              f"mesh (ZeRO-1 state, gradient mean over the batch group) against the meshless "
              f"run: largest relative loss difference {rel:.3e} (limit {TRAIN_RESUME_REL_TOL:g}); "
              f"losses {got[0]:.4f} .. {got[-1]:.4f}; step median "
              f"{meshed['straggler_report']['median_s'] * 1e3:.2f} ms against "
              f"{plain['straggler_report']['median_s'] * 1e3:.2f} ms without the mesh")
        if len(got) != MESH_TRAIN_STEPS or not rel <= TRAIN_RESUME_REL_TOL:
            failures.append(f"[mesh] (c) compress={compress}: {len(got)} steps, {rel:.3e}")
        if compress is None:
            straight = want
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckpt:
        _zero_counts()
        train(dataclasses.replace(base, mesh=mesh), steps=MESH_TRAIN_CKPT, ckpt_dir=ckpt,
              ckpt_every=MESH_TRAIN_CKPT, **kw)
        resumed = train(base, steps=MESH_TRAIN_STEPS, ckpt_dir=ckpt, **kw)["losses"]
        _no_kernel_launches("mesh lm-100m checkpointed, resumed without the mesh", failures)
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight[MESH_TRAIN_CKPT:]))
    print(f"[mesh] (c) lm-100m: {MESH_TRAIN_CKPT} steps on the mesh with a checkpoint, resumed "
          f"without a mesh for {len(resumed)} steps: largest relative loss difference to the "
          f"meshless run {rel:.3e} (limit {TRAIN_RESUME_REL_TOL:g})")
    if len(resumed) != MESH_TRAIN_STEPS - MESH_TRAIN_CKPT or not rel <= TRAIN_RESUME_REL_TOL:
        failures.append(f"[mesh] (c) resume without the mesh: {len(resumed)} steps, {rel:.3e}")
    _mesh_report(report, "(c) lm-100m training", t0)
    if not _issued()["all_reduce"]:
        failures.append("[mesh] (c): no all_reduce issued")
    torch.cuda.empty_cache()
    return straight


def mesh_collective_phase(torch, dev, failures, mesh, report) -> None:
    """(d) ``compressed_mean`` on the NCCL group of the mesh's batch axes, held
    against dequantize(quantize(x)) for both codecs."""
    from repro_torch.models.context import ParallelCtx
    from repro_torch.optim.compress import compressed_mean, round_trip
    from repro_torch.runtime import collectives

    t0 = time.perf_counter()
    collectives.reset()
    pctx = ParallelCtx(mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(MESH_COLLECTIVE_N, device=dev, generator=gen)
    for codec in ("int8", "elp4"):
        got, want = compressed_mean(x, pctx.batch_group, codec), round_trip(x, codec)
        err = (got - want).abs().max().item()
        print(f"[mesh] (d) compressed_mean {codec} of {MESH_COLLECTIVE_N} floats on the "
              f"{torch.distributed.get_backend(pctx.batch_group)} group of "
              f"{torch.distributed.get_world_size(pctx.batch_group)} rank: max |mean - round "
              f"trip| {err:.3e} (must be 0)")
        if err != 0.0:
            failures.append(f"[mesh] (d) compressed_mean {codec}: {err:.3e}")
    _mesh_report(report, "(d) compressed_mean", t0)
    if not _issued()["all_reduce"]:
        failures.append("[mesh] (d): no all_reduce issued")


# The cost phase: (a) the dry-run's cells on the 16 x 16 mesh (host only, each in a
# process of its own); (b) the (1, 1) cell of qwen3-8b elp4 at a decode shape the
# card holds, counted on meta and run for real; (c) serve_quantized --speculative.
COST_DRYRUN = (("qwen3_8b", "decode_32k", "elp4"), ("olmoe_1b_7b", "train_4k", None))
COST_ARCH, COST_CONTEXT, COST_SLOTS = "qwen3_8b", 4096, 16
COST_MEM_REL = 0.15  # predicted peak (baseline + arguments + step) within 15 % of the allocator's
COST_TIMED_STEPS = 5
SERVE_DEMO_STEPS = 30


def cost_phase(torch, dev, failures, rows, mesh) -> dict:
    """The dry-run and step-cost tooling on the card: (a) ``python -m
    repro_torch.launch.dryrun`` for qwen3-8b x decode_32k (elp4) and olmoe-1b-7b x
    train_4k on the 16 x 16 mesh of a fake group, in two processes at once, started
    once (b)'s steps are timed, each cell ``ok``, its roofline terms printed; (b)
    the dry-run's (1, 1) cell of
    qwen3-8b elp4 at COST_SLOTS slots and COST_CONTEXT positions, counted on
    ``meta`` (``dryrun.count_cell``), then the same step (``dryrun.cell_step``) on
    the card with seeded random weights (``dryrun.materialize``) under
    ``count_cost`` after ``reset_peak_memory_stats``: FLOPs, bytes and wire bytes
    equal to the meta count, kernel calls by route equal to the launch counters,
    argument bytes equal to the real tensors', the predicted peak within
    COST_MEM_REL of ``max_memory_allocated``, the step's time beside its roofline
    terms (eager traffic and least traffic); the step's kernel shapes held
    against their plain versions; (c)
    ``repro_torch.experiments.serve_quantized --speculative`` in this process
    (SERVE_DEMO_STEPS training steps), every kernel shape of it held. Returns the
    launches of (b)'s counted step and of (c)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, hlo_stats

    t_phase = time.perf_counter()

    # (b): meta, then the card
    cfg = get_config(COST_ARCH)
    shape = ShapeConfig("decode_4k", COST_CONTEXT, COST_SLOTS, "decode")
    t0 = time.perf_counter()
    rec = dryrun.count_cell(cfg, shape, mesh, "elp4")
    meta_s = time.perf_counter() - t0
    _collect(torch)
    base = torch.cuda.memory_allocated()
    step, args = dryrun.cell_step(cfg, shape, mesh, "elp4", device=dev,
                                  materialize=lambda t: dryrun.materialize(t, dev))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    arg_bytes = hlo_stats.tree_bytes(args)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with hlo_stats.count_cost() as real:
        out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    finite = bool(torch.isfinite(out[0]).all())
    del out
    m, cost = rec["memory"], rec["cost"]
    predicted = base + m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
    gap = predicted / peak - 1.0
    step_gap = (predicted - base) / max(peak - base, 1) - 1.0
    want_launches = {k: v for k, v in rec["kernels"].items() if v}
    got_launches = {k: v for k, v in launches.items() if v}
    print(f"[cost] (b) qwen3-8b elp4 decode, {COST_SLOTS} slots x {COST_CONTEXT} positions, "
          f"(1, 1) mesh: meta count in {meta_s:.1f} s: FLOPs {cost['flops_per_device']:.6e}, "
          f"bytes {cost['bytes_per_device']:.6e}, wire bytes "
          f"{rec['collectives']['per_device_bytes']:.1f}, kernels {rec['kernels']}; on the "
          f"card: FLOPs {real.flops:.6e}, bytes {real.bytes_accessed:.6e}, wire bytes "
          f"{real.collective_bytes:.1f}, kernel calls {real.kernels}, launches {got_launches}; "
          f"logits finite {finite}")
    print(f"[cost] (b) memory: arguments predicted {m['argument_bytes']} B, real tensors "
          f"{arg_bytes} B (allocator {held} B); outputs {m['output_bytes']} B, temp "
          f"{m['temp_bytes']} B; held before the step {base} B; predicted peak {predicted} B "
          f"against max_memory_allocated {peak} B: gap {gap:+.4f} (the step's own "
          f"{step_gap:+.4f}; limit {COST_MEM_REL:g})")
    for label, got, want in (("FLOPs", real.flops, cost["flops_per_device"]),
                             ("bytes", real.bytes_accessed, cost["bytes_per_device"]),
                             ("wire bytes", real.collective_bytes,
                              rec["collectives"]["per_device_bytes"]),
                             ("kernel calls", real.kernels, rec["kernels"]),
                             ("launches", got_launches, want_launches),
                             ("argument bytes", arg_bytes, m["argument_bytes"])):
        if got != want:
            failures.append(f"[cost] (b) {label} on the card {got} != meta {want}")
    if abs(gap) > COST_MEM_REL:
        failures.append(f"[cost] (b) predicted peak off by {gap:+.4f}")
    if not finite:
        failures.append("[cost] (b) non-finite logits")
    times = []
    for _ in range(COST_TIMED_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    # (a)'s processes start once (b)'s steps are timed: the step is launch-bound on
    # the host, and two meta evaluations beside it would slow it
    out_dir = os.path.join(ROOT, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         *(["--quant", quant] if quant else []), "--out", out_dir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape, quant in COST_DRYRUN]
    t = rec["roofline"]
    step_ms = statistics.median(times)
    print(f"[cost] (b) step time {step_ms:.3f} ms (median of {COST_TIMED_STEPS}, CUDA events; "
          f"runs {[round(x, 3) for x in times]}) against compute_s "
          f"{t['compute_s'] * 1e3:.4f} ms, memory_s {t['memory_s'] * 1e3:.3f} ms of eager "
          f"traffic ({cost['bytes_per_device']:.6e} B, every op's reads and writes) and "
          f"min_memory_s {t['min_memory_s'] * 1e3:.3f} ms of least traffic "
          f"({cost['min_bytes_per_device']:.6e} B, arguments read and outputs written once; "
          f"H100 datasheet rates): {t['memory_s'] * 1e3 / step_ms:.4f} of the eager-traffic "
          f"term, {t['min_memory_s'] * 1e3 / step_ms:.4f} of the least-traffic term")
    tap = KernelTap()
    with tap:
        step(*args)
    torch.cuda.synchronize()
    hold_tapped(torch, dev, "cost (b)", tap, rows, failures)
    del step, args, tap
    _collect(torch)

    # (a): the dry-run's processes
    for (arch, shape_name, quant), proc in zip(COST_DRYRUN, procs):
        out_text, err = proc.communicate(timeout=600)
        tail = out_text.strip().splitlines()[-1:] or [""]
        path = os.path.join(out_dir, f"{arch}__{shape_name}__16x16"
                                     f"{'__' + quant if quant else ''}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            failures.append(f"[cost] (a) dryrun {arch} {shape_name}: rc {proc.returncode} "
                            f"{err[-1500:]}")
            continue
        with open(path) as f:
            cell = json.load(f)
        r = cell.get("roofline", {})
        print(f"[cost] (a) dryrun {arch} x {shape_name} x 16x16 quant={cell['quant']}: "
              f"{cell['status']} ({tail[0]}); counted in {cell.get('count_s', 0):.1f} s; "
              f"{cell.get('memory', {}).get('total_per_device_gib', 0):.3f} GiB a device; "
              f"compute_s {r.get('compute_s', 0):.6f} memory_s {r.get('memory_s', 0):.6f} "
              f"(eager traffic; least {r.get('min_memory_s', 0):.6f}) collective_s {r.get('collective_s', 0):.6f} -> {r.get('bottleneck')}; "
              f"useful-FLOP ratio {r.get('useful_flop_ratio', 0):.3f}")
        if cell["status"] != "ok":
            failures.append(f"[cost] (a) dryrun {arch} {shape_name}: {cell.get('error')}")

    # (c): serve_quantized --speculative
    from repro_torch.experiments import serve_quantized

    os.environ["SERVE_DEMO_STEPS"] = str(SERVE_DEMO_STEPS)
    tap = KernelTap()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        with tap:
            serve_quantized.main(["--speculative"])
    except SystemExit as e:
        failures.append(f"[cost] (c) serve_quantized --speculative: {e}")
    torch.cuda.synchronize()
    c_launches = dict(zip(KERNEL_ROUTES, _counts()))
    print(f"[cost] (c) serve_quantized --speculative ({SERVE_DEMO_STEPS} training steps): "
          f"{time.perf_counter() - t0:.1f} s, launches {({k: v for k, v in c_launches.items() if v})}")
    hold_tapped(torch, dev, "cost (c)", tap, rows, failures)
    _collect(torch)
    print(f"[time] cost phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] + c_launches[k] for k in KERNEL_ROUTES}


TP_WORLD = 2  # ranks on the one card, a (1, 2) ("data", "model") mesh over gloo
TP_DIR = os.path.join(ROOT, "build", "tp")
TP_MOE_STEPS = 4  # olmoe: the prefill and 3 decode steps
TP_TRAIN_STEPS, TP_TRAIN_CKPT = MESH_TRAIN_STEPS, MESH_TRAIN_CKPT  # the mesh phase's (c)
TP_TRAIN_REL_TOL = 1e-5
TP_TIMEOUT_S = 900
TP_M2_TRAIN_LAYERS, TP_M2_TRAIN_STEPS = 4, 2  # (e): mamba2-780m training, full width
# (e): each family model's first TP_FAMILY_NEW new tokens of its family phase's
# LM_NEW: the script's time limit, not the checks, sets it
TP_FAMILY_NEW = 8
# (d): the first MESH_REQUESTS engine requests, each cut to its first TP_ENGINE_NEW new
# tokens (the engine phase's profiled run's cut): the script's time limit, not the
# checks, sets it
TP_ENGINE_NEW = PROFILED_NEW


def tp_save(torch, qm, name, **refs) -> None:
    """One model's input to the TP phase, as a user hands a model over: the
    checksummed artifact (saved once here, loaded by each rank) and the meshless
    run's references, on the host."""
    d = os.path.join(TP_DIR, name)
    t0 = time.perf_counter()
    shutil.rmtree(d, ignore_errors=True)
    qm.save(d)
    host = {k: [t.cpu() for t in v] if isinstance(v, list)
            else v.cpu() if hasattr(v, "cpu") else v for k, v in refs.items()}
    torch.save(host, d + ".refs.pt")
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)
    print(f"[tp] {name}: artifact of {size} B saved for the TP ranks in "
          f"{time.perf_counter() - t0:.1f} s")


def tp_phase(torch, failures, rows, straight) -> dict:
    """The tensor-parallel phase: TP_WORLD processes share the card (NCCL refuses
    two ranks on one device, so a ``gloo`` group on a ``FileStore`` carries the
    card's tensors over the host) on a (1, 2) mesh, each loading the artifacts
    that the LM, MoE and family phases saved and resharding them
    (``tp_rank_main``). A
    rank that fails (or outlives TP_TIMEOUT_S) fails the run, and the other is
    stopped. Returns the launches of the ranks' main-path runs, by route; their
    held kernel shapes join ``rows``."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    os.makedirs(TP_DIR, exist_ok=True)
    torch.save({"losses": list(straight)}, os.path.join(TP_DIR, "lm100m.refs.pt"))
    store = os.path.join(TP_DIR, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_rank_main, args=(r, TP_WORLD, store)) for r in range(TP_WORLD)]
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + TP_TIMEOUT_S
    while any(pr.is_alive() for pr in procs):
        failed = any(pr.exitcode not in (None, 0) for pr in procs)
        if failed or time.monotonic() > deadline:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
            if not failed:
                failures.append(f"[tp] the ranks outlived {TP_TIMEOUT_S} s")
        time.sleep(0.5)
    launches = collections.Counter()
    for r, pr in enumerate(procs):
        pr.join()
        if pr.exitcode != 0:
            failures.append(f"[tp] rank {r} exited with {pr.exitcode}")
        path = os.path.join(TP_DIR, f"rank{r}.json")
        if not os.path.exists(path):
            failures.append(f"[tp] rank {r} wrote no result")
            continue
        with open(path) as f:
            res = json.load(f)
        failures.extend(res["failures"])
        launches.update(res["launches"])
        for k, rs in res["rows"].items():
            rows[k].extend(rs)
        print(f"[tp] rank {r}: {json.dumps(res['report'])}")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    print(f"[tp] launches of the ranks' main-path runs {dict(launches)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {k: launches[k] for k in KERNEL_ROUTES}


def tp_rank_main(rank: int, world: int, store: str) -> None:
    """One rank of the TP phase on ``cuda:0``: qwen3-8b (``_tp_qwen3``), olmoe-1b-7b
    (``_tp_olmoe``), lm-100m training (``_tp_train``) and the recurrent and enc-dec
    families (``_tp_families``) over the (1, 2) mesh; its failures, launches, held
    kernel rows and report to TP_DIR/rank<r>.json."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    from repro_torch.runtime.elastic import make_mesh

    dev = torch.device("cuda")
    mesh = make_mesh(target_model=world, device=dev)
    out = {"failures": [], "rows": {k: [] for k in KERNEL_ROUTES}, "launches": {},
           "report": {"mesh": str(mesh), "backend": dist.get_backend()}}
    try:
        for part in (_tp_qwen3, _tp_olmoe, _tp_train, _tp_families):  # (d) inside _tp_qwen3
            part(torch, dev, mesh, rank, out)
            dist.barrier()
    except BaseException:
        out["failures"].append(f"[tp] rank {rank}: {traceback.format_exc()[-3000:]}")
        raise
    finally:
        with open(os.path.join(TP_DIR, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def _tp_held(torch, dev, mesh, rank, label, tap, out) -> None:
    """``hold_tapped`` on each rank in turn, so no two ranks time the card at once."""
    import torch.distributed as dist

    for r in range(mesh.size()):
        if r == rank:
            hold_tapped(torch, dev, f"tp rank {rank}: {label}", tap, out["rows"], out["failures"])
        dist.barrier()


def _tp_issued_ok(label, issued, want, out) -> None:
    got = {k: issued.get(k, 0) for k in want}
    print(f"[tp] {label}: collectives by kind {got} (expected {want})")
    if got != want:
        out["failures"].append(f"[tp] {label}: collectives {got}, expected {want}")


def _tp_qwen3(torch, dev, mesh, rank, out) -> None:
    """(a) Full-width qwen3-8b, a4 per slice, static 8-bit activations, from the LM
    phase's artifact: ``static_generate`` through ``ServeSetup(mesh)`` at the
    lockstep geometry, launches per route per model call exact, collectives by
    kind exact; the model teacher-forced on the meshless run's tokens within the
    LM gate of the meshless kernels' logits, this run's tokens parting from the
    meshless ones only within the gate of the top logit; prefill and decode ms
    and peak memory; every kernel shape of the run held against its plain
    version on its own inputs. Then the float-activation control of the logit
    reading (``_tp_float_control``) and, on the same loaded artifact, the
    engine over the ranks (``_tp_engine``, part (d))."""
    import repro_torch.models.transformer as transformer
    import repro_torch.serve.engine as engine_mod
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.runtime import collectives

    tag = f"[tp r{rank}] (a) qwen3-8b"
    cfg = get_config("qwen3_8b")
    n_layers, per_layer = cfg.n_layers, 7
    t0 = time.perf_counter()
    d = os.path.join(TP_DIR, "qwen3_8b")
    qm = api.load(d, device=dev)
    refs = torch.load(d + ".refs.pt")
    prompts, new = refs["prompts"].to(dev), refs["tokens"].to(dev)
    ref_logits = [t.to(dev) for t in refs["logits"]]
    print(f"{tag}: artifact loaded (checksums held) in {time.perf_counter() - t0:.1f} s")
    setup = engine_mod.ServeSetup(cfg=cfg, mesh=mesh, max_len=LM_PROMPT + LM_NEW, batch=LM_BATCH)
    tap = KernelTap()
    collectives.reset()
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tap:
        got, phases = _phased(torch, lambda: engine_mod.static_generate(
            setup, qm.params, {"tokens": prompts}, LM_NEW))
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    out["launches"] = dict(collections.Counter(out["launches"]) + collections.Counter(launches))
    prefill_counts = _expected({"elp_bsd_matmul/wgmma": n_layers * per_layer,
                                "flash_attention/wgmma": n_layers})
    step_counts = _expected({"fused_decode_matmul/wgmma": n_layers * per_layer})
    want = [("prefill", prefill_counts)] + [("decode", step_counts)] * (LM_NEW - 1)
    print(f"{tag}: static_generate over {setup.mesh} ({LM_BATCH} x {LM_PROMPT} prompts, "
          f"{LM_NEW} new) in {gen_s:.2f} s; launches by phase exact {phases == want} (prefill "
          f"{phases[0][1] if phases else None}, decode steps "
          f"{sorted(set(p_[1] for p_ in phases[1:]))}); max_memory_allocated {peak} B")
    if phases != want:
        out["failures"].append(f"[tp] (a) rank {rank}: launches by phase {phases}")
    # a call: the embedding's and each layer's two row-parallel sums, the head's gather
    _tp_issued_ok(f"r{rank} (a) static_generate", collectives.ISSUED,
                  {"all_reduce": LM_NEW * (1 + 2 * n_layers), "all_gather": LM_NEW,
                   "reduce_scatter": 0, "all_to_all": 0}, out)
    if tuple(got.shape) != (LM_BATCH, LM_NEW) or int(got.min()) < 0 or int(got.max()) >= cfg.vocab:
        out["failures"].append(f"[tp] (a) tokens of shape {tuple(got.shape)} or out of the vocab")

    # teacher-forced on the meshless tokens, timed per call
    params, cache = setup.layout(qm.params, transformer.init_cache(
        cfg, LM_BATCH, LM_PROMPT + LM_NEW, device=dev))
    pctx = setup.pctx()
    step_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, cfg, prompts, cache, pctx=pctx)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    forced = [logits]
    for i in range(LM_NEW - 1):
        t0 = time.perf_counter()
        logits, cache = transformer.decode_step(params, cfg, new[:, i:i + 1], cache,
                                                LM_PROMPT + i, pctx=pctx)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        forced.append(logits)
    rel = _rel(forced, ref_logits)
    parted = _first_partings(got, new, [t[:, -1] for t in ref_logits])
    same = LM_BATCH - len(parted)
    print(f"{tag}: teacher-forced on the meshless tokens, max |logit diff| / max |logit| "
          f"against the meshless kernels' {rel:.3e} (limit {LM_LOGIT_REL_TOL:g}); rows of this "
          f"run identical to the meshless tokens {same}/{LM_BATCH}, partings (row, position, "
          f"gap below the meshless top logit / max |logit|) {parted}; prefill ms {pre_ms:.2f}, "
          f"decode ms a step median {statistics.median(step_ms):.2f} (meshless "
          f"{refs['prefill_ms']:.2f} and {refs['decode_ms']:.2f}, one process alone)")
    if not rel <= LM_LOGIT_REL_TOL:
        out["failures"].append(f"[tp] (a) rank {rank}: logits {rel:.3e} against the meshless")
    for row, j, gap in parted:
        if gap > LM_LOGIT_REL_TOL:
            out["failures"].append(f"[tp] (a) rank {rank}: row {row} parts at {j} by {gap:.3e}")
    out["report"]["qwen3"] = {"logit_rel": rel, "rows_same": same, "prefill_ms": pre_ms,
                              "decode_ms_median": statistics.median(step_ms),
                              "peak_bytes": peak, "generate_s": gen_s}
    del params, cache, forced, logits
    _tp_float_control(torch, dev, setup, qm, prompts, new, rel, rank, out)
    _tp_held(torch, dev, mesh, rank, "qwen3-8b static_generate", tap, out)
    _tp_engine(torch, dev, mesh, rank, out, qm, cfg, refs["calib"].to(dev))
    del qm
    torch.cuda.empty_cache()


def _strip_act(tree):
    """``tree`` with every packed weight's static activation quantizer taken off
    (the same codes: float activations into the same products)."""
    from repro_torch.kernels.ops import PackedWeight

    if isinstance(tree, dict):
        return {k: _strip_act(v) for k, v in tree.items()}
    if isinstance(tree, PackedWeight) and tree.act_scale is not None:
        return dataclasses.replace(tree, act_scale=None, act_bits=None)
    return tree


def _float32_tree(tree):
    """``tree`` with every float leaf outside its packed weights in float32 (the
    codes and their scales as they are)."""
    from repro_torch.kernels.ops import PackedWeight

    if isinstance(tree, dict):
        return {k: _float32_tree(v) for k, v in tree.items()}
    return tree if isinstance(tree, PackedWeight) else tree.float()


def _tp_float_control(torch, dev, setup, qm, prompts, new, rel_static, rank, out) -> None:
    """The controls of (a)'s logit reading: the same teacher-forced comparison, the
    (1, 2) run against the meshless one, both on the kernels, on the loaded tree
    with its static activation scales taken off, in the model's bf16 and in a
    float32 copy (the float leaves in float32, the matmuls on the bf16x3 routes,
    the attention on the float32 flash kernel). Where the float reading is not
    well below the static one, the static 8-bit activations are not what parts
    the two runs; where the float32 copy reads within FLOAT_LOGIT_REL_TOL, the
    tensor-parallel path computes the meshless function and what parts the bf16
    runs is bf16 rounding of float32 sums taken in another order."""
    import repro_torch.models.transformer as transformer

    tree = _strip_act(qm.params)

    def forced(cfg, params, pctx) -> list:
        cache = transformer.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW, device=dev)
        if pctx is not None:
            params, cache = setup.layout(params, cache)
        logits, cache = transformer.prefill(params, cfg, prompts, cache, pctx=pctx)
        outs = [logits]
        for i in range(LM_NEW - 1):
            logits, cache = transformer.decode_step(params, cfg, new[:, i:i + 1], cache,
                                                    LM_PROMPT + i, pctx=pctx)
            outs.append(logits)
        return outs

    readings = {}
    for label, cfg, params in (
            ("bf16", setup.cfg, tree),
            ("float32", dataclasses.replace(setup.cfg, dtype_str="float32"), _float32_tree(tree))):
        t0 = time.perf_counter()
        meshless = forced(cfg, params, None)
        readings[label] = _rel(forced(cfg, params, setup.pctx()), meshless)
        del meshless
        torch.cuda.empty_cache()
        print(f"[tp r{rank}] (a) control: float activations (the tree's static scales taken "
              f"off), {label}, teacher-forced (1, 2) against meshless on the kernels, max "
              f"|logit diff| / max |logit| {readings[label]:.3e}"
              f"{f' (limit {FLOAT_LOGIT_REL_TOL:g})' if label == 'float32' else ''}; with the "
              f"static 8-bit activations {rel_static:.3e} ({time.perf_counter() - t0:.1f} s)")
    if not math.isfinite(readings["bf16"]):
        out["failures"].append(f"[tp] (a) rank {rank}: float control reading {readings['bf16']}")
    if not readings["float32"] <= FLOAT_LOGIT_REL_TOL:
        out["failures"].append(f"[tp] (a) rank {rank}: float32 control reading "
                               f"{readings['float32']:.3e}")
    out["report"]["qwen3_float_control"] = {"logit_rel_float": readings["bf16"],
                                            "logit_rel_float32": readings["float32"],
                                            "logit_rel_static": rel_static}


def _tp_engine(torch, dev, mesh, rank, out, qm, cfg, calib) -> None:
    """(d) qwen3-8b (the loaded artifact) on the continuous-batching engine over the
    ranks, the first MESH_REQUESTS engine requests (cut to TP_ENGINE_NEW new tokens;
    a request's tokens are compared with the first ones of the meshless engine's)
    into ENGINE_SLOTS slots: on the
    (1, 2) mesh the dense cache, the paged static-int8 cache, that with ngram
    speculation and the dense cache with flash-decode (every KV head for the
    rank's half of the positions); on a (2, 1) mesh over the same ranks the dense
    and the paged cache, each rank holding its four slots. Per rank and run:
    launches per route exact per model call, collectives by kind exact (one
    ``agree`` a step), tokens equal on both ranks and under the teacher-forced
    gate of the meshless kernels' logits, the paged runs' prefix hits those the
    trace implies and the meshless engine's (the mesh phase's (a) saves its
    tokens and hits on these requests); then every kernel shape of the runs
    (the (1, 2) runs' sharded weights, the (2, 1) runs' four rows a rank) held
    against its plain version on its own inputs."""
    import torch.distributed as dist

    import repro_torch.serve.engine as engine_mod
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.runtime import collectives
    from repro_torch.runtime.elastic import make_mesh

    t_part = time.perf_counter()
    n_layers = cfg.n_layers
    dp_mesh = make_mesh(target_model=1, device=dev)  # (2, 1): every rank of the group calls it
    reqs = [(p, min(n, TP_ENGINE_NEW)) for p, n in engine_requests(cfg.vocab)[:MESH_REQUESTS]]
    scales = calibrate_kv_cache(qm.params, cfg, calib)
    geom = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN)
    paged = dict(kv_cache="paged", page_size=ENGINE_PAGE, kv_scales=scales)
    runs = (
        ("(1, 2) dense", mesh, {}),
        ("(1, 2) paged int8", mesh, paged),
        ("(1, 2) paged int8, ngram spec_k 4", mesh, dict(paged, spec_k=ENGINE_SPEC_K,
                                                         spec_draft="ngram")),
        ("(1, 2) dense, flash-decode", mesh, {"flash_decode": True}),
        ("(2, 1) dense", dp_mesh, {}),
        ("(2, 1) paged int8", dp_mesh, paged),
    )
    meshless_runs = {}  # the mesh phase's meshless engine on the same requests, this run's
    for name in ("dense", "paged"):
        path = os.path.join(TP_DIR, f"qwen3_8b.engine_{name}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"(d): the mesh phase wrote no meshless engine run {path}")
        meshless_runs[name] = torch.load(path)
    tap = KernelTap()
    forced_cache = {}
    report = {}
    total = collections.Counter()
    for label, m, kw in runs:
        tag = f"[tp r{rank}] (d) {label}"
        collectives.reset()
        readings = {}
        outs, eng, launches = _serve_run(
            torch, tag, lambda reg, log, m=m, kw=kw: engine_mod.ServeEngine(
                cfg, qm.params, metrics=reg, trace=log, mesh=m, **geom, **kw).serve(reqs),
            reqs, out["failures"], tap, paged="kv_cache" in kw, readings=readings)
        issued = dict(collectives.ISSUED)
        total.update(launches)
        st = eng.stats()
        calls, steps = st["prefills"] + st["decode_steps"], eng.steps
        if m is dp_mesh:  # a dense admission's logits from its row's rank, the rows' tokens
            want = {"all_reduce": 0 if "kv_cache" in kw else st["prefills"],
                    "all_gather": st["decode_steps"]}
        elif kw.get("flash_decode"):
            # an admission gathers its k and v heads whole, a decode call its q, k
            # and v heads and sums the statistics' max and sum; the head's gather
            want = {"all_reduce": st["prefills"] * (1 + 2 * n_layers)
                    + st["decode_steps"] * (1 + 4 * n_layers),
                    "all_gather": st["prefills"] * (2 * n_layers + 1)
                    + st["decode_steps"] * (3 * n_layers + 1)}
        else:  # the embedding's and each layer's two row-parallel sums, the head's gather
            want = {"all_reduce": calls * (1 + 2 * n_layers), "all_gather": calls}
        want.update(agree=steps, reduce_scatter=0, all_to_all=0)
        _tp_issued_ok(f"r{rank} (d) {label} ({st['prefills']} admissions, "
                      f"{st['decode_steps']} decode calls, {steps} steps)", issued, want, out)
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, [o.tolist() for o in outs])
        same = all(e == everyone[0] for e in everyone)
        meshless = meshless_runs["paged" if "kv_cache" in kw else "dense"]
        ident = sum(a == b[:len(a)] for a, b in zip(everyone[rank], meshless["outs"]))
        print(f"{tag}: tokens equal on every rank {same}; mesh {st['mesh']}; requests "
              f"identical to the meshless engine's (the mesh phase's (a)) {ident}/{len(reqs)}")
        if "kv_cache" in kw:
            hits = st["cache"]["prefix_hits"]
            print(f"{tag}: prefix hits {hits}, the meshless engine's {meshless['prefix_hits']}")
            if hits != meshless["prefix_hits"]:
                out["failures"].append(f"[tp] (d) {label}: prefix hits {hits} against the "
                                       f"meshless engine's {meshless['prefix_hits']}")
        if not same:
            out["failures"].append(f"[tp] (d) {label}: the ranks' tokens differ")
        kv = scales if "kv_cache" in kw else None
        key = (kv is not None, tuple(o.tobytes() for o in outs))
        if key not in forced_cache:
            forced_cache[key] = _forced_pair(torch, qm.params, cfg, reqs, outs, kv,
                                             out["failures"])
        _engine_held(torch, tag, forced_cache[key], outs, out["failures"])
        mon = st["straggler"]
        report[label] = {"issued": issued, "launches": launches, "steps": steps,
                         "decode_ms_median": mon["median_s"] * 1e3,
                         "ttft_p50_ms": statistics.median(readings["ttft_ms"]),
                         "prefix_hits": st["cache"]["prefix_hits"], "same_as_meshless": ident}
        del eng
        torch.cuda.empty_cache()
    forced_cache.clear()
    out["launches"] = dict(collections.Counter(out["launches"]) + total)
    _tp_held(torch, dev, mesh, rank, "qwen3-8b engine (d)", tap, out)
    secs = time.perf_counter() - t_part
    out["report"]["engine_d"] = {"runs": report, "s": secs}
    print(f"[tp r{rank}] (d) launches of the engine runs {dict(total)}; part (d) {secs:.1f} s")


def _tp_olmoe(torch, dev, mesh, rank, out) -> None:
    """(b) Full-width olmoe-1b-7b from the MoE phase's artifact through ``moe_ep``
    on the mesh: ``static_generate`` of the prefill and 3 decode steps (launches
    per route per call and collectives by kind exact, the dropped share at the
    config's capacity), then teacher-forced with the routing forced to the
    meshless plain run's at a capacity that drops nothing: the logits within
    the MoE gate of the plain run's, the rank's own top-8 sets within the
    routing-flip limit of the forced ones; every kernel shape of the generate
    held against its plain version on its own inputs."""
    import repro_torch.models.moe as moe_lib
    import repro_torch.models.transformer as transformer
    import repro_torch.serve.engine as engine_mod
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.runtime import collectives

    tag = f"[tp r{rank}] (b) olmoe-1b-7b"
    cfg = get_config("olmoe_1b_7b")
    n_layers, n = cfg.n_layers, TP_MOE_STEPS
    t0 = time.perf_counter()
    d = os.path.join(TP_DIR, "olmoe_1b_7b")
    qm = api.load(d, device=dev)
    refs = torch.load(d + ".refs.pt")
    prompts, new = refs["prompts"].to(dev), refs["tokens"].to(dev)
    p_ids = [t.to(dev) for t in refs["plain_ids"]]
    p_logits, k_logits = ([t.to(dev) for t in refs[k]] for k in ("plain_logits", "logits"))
    print(f"{tag}: artifact loaded in {time.perf_counter() - t0:.1f} s")
    setup = engine_mod.ServeSetup(cfg=cfg, mesh=mesh, max_len=LM_PROMPT + n, batch=LM_BATCH,
                                  moe_impl="ep")
    drops = collections.Counter()
    real = moe_lib.ep_dispatch

    def counted(x_loc, router, cfg_, n_shards, logits=None):
        r = real(x_loc, router, cfg_, n_shards, logits)
        kind = "prefill" if x_loc.shape[0] > LM_BATCH else "decode"
        drops[kind, "dropped"] += r["dropped"].sum()
        drops[kind, "pairs"] += r["dropped"].numel()
        return r

    collectives.reset()
    _zero_counts()
    moe_lib.ep_dispatch = counted
    tap = KernelTap()
    t0 = time.perf_counter()
    try:
        with tap:
            got, phases = _phased(torch, lambda: engine_mod.static_generate(
                setup, qm.params, {"tokens": prompts}, n))
    finally:
        moe_lib.ep_dispatch = real
    gen_s = time.perf_counter() - t0
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    out["launches"] = dict(collections.Counter(out["launches"]) + collections.Counter(launches))
    want = ([("prefill", _expected({"elp_bsd_matmul/wgmma": n_layers * MOE_PER_LAYER,
                                    "flash_attention/wgmma": n_layers}))]
            + [("decode", _expected({"fused_decode_matmul/wgmma": n_layers * MOE_PER_LAYER}))]
            * (n - 1))
    share = {kind: int(drops[kind, "dropped"]) / max(int(drops[kind, "pairs"]), 1)
             for kind in ("prefill", "decode")}
    print(f"{tag}: static_generate through moe_ep at capacity factor "
          f"{cfg.moe_capacity_factor} in {gen_s:.2f} s; launches by phase exact {phases == want}; "
          f"dropped share of this rank's (token, choice) pairs: prefill {share['prefill']:.4f} "
          f"of {int(drops['prefill', 'pairs'])}, decode {share['decode']:.4f} of "
          f"{int(drops['decode', 'pairs'])}")
    if phases != want:
        out["failures"].append(f"[tp] (b) rank {rank}: launches by phase {phases}")
    # a call: the embedding's sum, each layer's wo sum, router gather, exchange out
    # and back, token gather; the head's gather
    _tp_issued_ok(f"r{rank} (b) static_generate", collectives.ISSUED,
                  {"all_reduce": n * (1 + n_layers), "all_gather": n * (1 + 2 * n_layers),
                   "all_to_all": n * 2 * n_layers, "reduce_scatter": 0}, out)
    if tuple(got.shape) != (LM_BATCH, n) or int(got.min()) < 0 or int(got.max()) >= cfg.vocab:
        out["failures"].append(f"[tp] (b) tokens of shape {tuple(got.shape)} or out of the vocab")

    ample = dataclasses.replace(cfg, moe_capacity_factor=cfg.n_experts / cfg.topk)
    setup = dataclasses.replace(setup, cfg=ample)
    params, cache = setup.layout(qm.params, transformer.init_cache(cfg, LM_BATCH, LM_PROMPT + n,
                                                                   device=dev))
    pctx = setup.pctx()
    with RouteTap(force=p_ids, rank=pctx.model_rank) as rt:
        logits, cache = transformer.prefill(params, ample, prompts, cache, pctx=pctx)
        forced = [logits]
        for i in range(n - 1):
            logits, cache = transformer.decode_step(params, ample, new[:, i:i + 1], cache,
                                                    LM_PROMPT + i, pctx=pctx)
            forced.append(logits)
    del params, cache
    differ = total = 0
    for c in range(n):
        for layer in range(n_layers):
            own = rt.ids[c * n_layers + layer]
            ref = p_ids[c * n_layers + layer]
            rows = own.shape[0]
            ref = ref[pctx.model_rank * rows:(pctx.model_rank + 1) * rows]
            dd = (own != ref).any(-1)
            differ, total = differ + int(dd.sum()), total + dd.numel()
    flips, rel, rel_k = differ / total, _rel(forced, p_logits), _rel(forced, k_logits)
    print(f"{tag}: routing forced to the meshless plain run's (capacity factor "
          f"{ample.moe_capacity_factor}: no drops), teacher-forced: this rank's own top-"
          f"{cfg.topk} sets differ from the forced ids in {flips:.3e} of {total} (limit "
          f"{ROUTE_FLIP_LIMIT:g}); max |logit diff| / max |logit| against the plain run's "
          f"{rel:.3e} (limit {MOE_LOGIT_REL_TOL:g}), against the meshless kernels' {rel_k:.3e}")
    if flips > ROUTE_FLIP_LIMIT or rel > MOE_LOGIT_REL_TOL:
        out["failures"].append(f"[tp] (b) rank {rank}: routing {flips:.3e}, logits {rel:.3e}")
    out["report"]["olmoe"] = {"dropped": share, "flips": flips, "logit_rel": rel,
                              "logit_rel_kernels": rel_k, "generate_s": gen_s}
    del forced
    _tp_held(torch, dev, mesh, rank, "olmoe-1b-7b static_generate", tap, out)
    del qm
    torch.cuda.empty_cache()


def _tp_train(torch, dev, mesh, rank, out) -> None:
    """(c) lm-100m, the mesh phase's (c) run over the (1, 2) mesh (without remat:
    the same losses, a third fewer collectives): TP_TRAIN_STEPS steps without and
    with ``seq_parallel``, the losses within TP_TRAIN_REL_TOL relative of the
    meshless run's, no kernel launched, ``reduce_scatter`` issued only with
    ``seq_parallel``. The sequence-parallel run writes a checkpoint at
    TP_TRAIN_CKPT and resumes from it on the mesh; rank 0 also resumes a copy
    of it without a mesh."""
    import torch.distributed as dist

    from repro_torch.experiments import train_lm
    from repro_torch.runtime import collectives
    from repro_torch.runtime.train_loop import TrainSetup, train

    straight = torch.load(os.path.join(TP_DIR, "lm100m.refs.pt"))["losses"]
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=TP_TRAIN_STEPS, device=dev,
              log_fn=lambda line: None)
    base = TrainSetup(cfg=train_lm.CFG, lr_peak=6e-4, warmup=50, total_steps=TRAIN_STEPS,
                      remat=False)
    ckpt = os.path.join(TP_DIR, "ckpt")
    if rank == 0:
        for d in (ckpt, ckpt + "_meshless"):
            shutil.rmtree(d, ignore_errors=True)
    dist.barrier()
    report = {}

    def check(label, got, want, t0):
        fails = []
        _no_kernel_launches(f"[tp] (c) rank {rank} lm-100m {label}", fails)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[tp r{rank}] (c) lm-100m {label}, {len(got)} steps in "
              f"{time.perf_counter() - t0:.1f} s: largest relative loss difference to the "
              f"meshless run {rel:.3e} (limit {TP_TRAIN_REL_TOL:g})")
        if len(got) != len(want) or not rel <= TP_TRAIN_REL_TOL:
            fails.append(f"[tp] (c) rank {rank} {label}: {len(got)} steps, {rel:.3e}")
        out["failures"].extend(fails)
        return rel

    for sp in (False, True):
        label = f"seq_parallel={sp} on {mesh}"
        setup = dataclasses.replace(base, mesh=mesh, seq_parallel=sp)
        collectives.reset()
        _zero_counts()
        t0 = time.perf_counter()
        if not sp:
            run = train(setup, steps=TP_TRAIN_STEPS, **kw)
            got, step_ms = run["losses"], run["straggler_report"]["median_s"] * 1e3
        else:
            first = train(setup, steps=TP_TRAIN_CKPT, ckpt_dir=ckpt, ckpt_every=TP_TRAIN_CKPT,
                          **kw)
            issued = dict(collectives.ISSUED)
            if rank == 0:
                shutil.copytree(ckpt, ckpt + "_meshless")
                t1 = time.perf_counter()
                resumed = train(base, steps=TP_TRAIN_STEPS, ckpt_dir=ckpt + "_meshless",
                                **kw)["losses"]
                report["resumed_without_mesh_rel"] = check(
                    f"checkpoint of the mesh run at step {TP_TRAIN_CKPT}, resumed without a "
                    "mesh", resumed, straight[TP_TRAIN_CKPT:], t1)
            dist.barrier()
            collectives.reset()
            collectives.ISSUED.update(issued)
            _zero_counts()
            second = train(setup, steps=TP_TRAIN_STEPS, ckpt_dir=ckpt, **kw)
            got = first["losses"] + second["losses"]
            step_ms = second["straggler_report"]["median_s"] * 1e3
        issued = dict(collectives.ISSUED)
        rel = check(label + (f" (resumed on the mesh at step {TP_TRAIN_CKPT})" if sp else ""),
                    got, straight, t0)
        print(f"[tp r{rank}] (c) lm-100m {label}: step median {step_ms:.1f} ms; collectives "
              f"{issued}")
        if (issued["reduce_scatter"] > 0) != sp or not issued["all_reduce"]:
            out["failures"].append(f"[tp] (c) rank {rank} {label}: collectives {issued}")
        report[f"seq_parallel={sp}"] = {"loss_rel": rel, "step_ms": step_ms, "issued": issued}
    out["report"]["lm100m"] = report


def _family_collectives(cfg, m: int) -> tuple[dict, dict]:
    """Collectives by kind of one prefill and of one decode step of a recurrent or
    enc-dec model on a model axis of ``m`` ranks, where every rule block divides:
    the embedding's vocab blocks summed (its feature blocks gathered where the
    vocab does not divide) and the head's vocab blocks gathered (its feature
    blocks' partial logits summed); a mamba2 layer gathers ``in_proj``'s columns
    and the conv's channels and sums the gated norm's squares and ``out_proj``'s
    rows; an RG-LRU layer gathers the conv output and sums ``w_out``'s and
    ``w2``'s rows; a local-attention layer gathers ``wk``'s and ``wv``'s columns
    where they split the KV heads and sums ``wo``'s and ``w2``'s rows; an
    encoder layer sums two row-parallel products, a decoder layer three (self,
    cross, MLP), and the prefill gathers ``frontend_proj``'s columns."""
    vocab_split = cfg.vocab % m == 0
    call = collections.Counter({"all_reduce" if vocab_split else "all_gather": 1})
    call["all_gather" if vocab_split else "all_reduce"] += 1
    if cfg.family == "ssm":
        call.update({"all_gather": 2 * cfg.n_layers, "all_reduce": 2 * cfg.n_layers})
        return dict(call), dict(call)
    if cfg.family == "hybrid":
        n_attn = sum(cfg.period[i % len(cfg.period)] == "attn" for i in range(cfg.n_layers))
        call.update({"all_reduce": 2 * cfg.n_layers,
                     "all_gather": cfg.n_layers - n_attn
                     + (2 * n_attn if cfg.n_kv_heads % m else 0)})
        return dict(call), dict(call)
    step = call + collections.Counter({"all_reduce": 3 * cfg.n_dec_layers})
    prefill = step + collections.Counter({"all_reduce": 2 * cfg.n_layers, "all_gather": 1})
    return dict(prefill), dict(step)


def _tp_families(torch, dev, mesh, rank, out) -> None:
    """(e) The recurrent and enc-dec families over the (1, 2) mesh: each model of
    FAMILY_ARCHS from its family phase's artifact (``_tp_family``), then
    mamba2-780m training (``_tp_family_train``)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    for arch in FAMILY_ARCHS:
        _tp_family(torch, dev, mesh, rank, out, arch)
        dist.barrier()
    _tp_family_train(torch, dev, mesh, rank, out)
    print(f"[tp r{rank}] (e) {time.perf_counter() - t0:.1f} s")


def _tp_family(torch, dev, mesh, rank, out, arch: str) -> None:
    """(e) One recurrent or enc-dec model at full width and depth, a4 per slice,
    float activations, from its family phase's artifact: ``static_generate``
    through ``ServeSetup(mesh)`` at the family phase's geometry (its first
    TP_FAMILY_NEW new tokens), launches per
    route per model call exact (every packed slice once a call, at this rank's
    block), collectives by kind exact (``_family_collectives``), the tokens
    equal on both ranks; the model teacher-forced on the meshless run's tokens
    within the family's logit gate of the meshless kernels' logits; prefill and
    decode ms and peak memory per rank; every kernel shape of the run held
    against its plain version on its own inputs."""
    import torch.distributed as dist

    import repro_torch.serve.engine as engine_mod
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.runtime import collectives

    cfg = get_config(arch)
    model = get_model(cfg)
    tag = f"[tp r{rank}] (e) {cfg.name}"
    t0 = time.perf_counter()
    d = os.path.join(TP_DIR, arch)
    qm = api.load(d, device=dev)
    refs = torch.load(d + ".refs.pt")
    batch = {"tokens": refs["prompts"].to(dev)}
    if refs["frames"] is not None:
        batch["frontend"] = refs["frames"].to(dev)
    n = TP_FAMILY_NEW
    new = refs["tokens"][:, :n].to(dev)
    ref_logits = [t.to(dev) for t in refs["logits"][:n]]
    print(f"{tag}: artifact loaded in {time.perf_counter() - t0:.1f} s")
    max_len = LM_PROMPT + n
    setup = engine_mod.ServeSetup(cfg=cfg, mesh=mesh, max_len=max_len, batch=LM_BATCH)
    tap = KernelTap()
    collectives.reset()
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tap:
        got, phases = _phased(torch, lambda: engine_mod.static_generate(
            setup, qm.params, batch, n))
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(zip(KERNEL_ROUTES, _counts()))
    out["launches"] = dict(collections.Counter(out["launches"]) + collections.Counter(launches))
    prefill_counts, step_counts = _family_launches(cfg, qm.params)
    want = [("prefill", prefill_counts)] + [("decode", step_counts)] * (n - 1)
    frames = f" + {batch['frontend'].shape[1]} frames" if "frontend" in batch else ""
    print(f"{tag}: static_generate over {setup.mesh} ({LM_BATCH} x {LM_PROMPT} prompts{frames}, "
          f"{n} new) in {gen_s:.2f} s; launches by phase exact {phases == want} (prefill "
          f"{phases[0][1] if phases else None}, decode steps "
          f"{sorted(set(p_[1] for p_ in phases[1:]))}); max_memory_allocated {peak} B")
    if phases != want:
        out["failures"].append(f"[tp] (e) {cfg.name} rank {rank}: launches by phase {phases}")
    pre, step = _family_collectives(cfg, mesh.size())
    _tp_issued_ok(f"r{rank} (e) {cfg.name} static_generate", collectives.ISSUED,
                  {k: pre.get(k, 0) + (n - 1) * step.get(k, 0)
                   for k in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")}, out)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, got.tolist())
    if any(e != everyone[0] for e in everyone) or tuple(got.shape) != (LM_BATCH, n):
        out["failures"].append(f"[tp] (e) {cfg.name} rank {rank}: tokens differ between the "
                               f"ranks or of shape {tuple(got.shape)}")

    # teacher-forced on the meshless tokens, timed per call
    params, state = setup.layout(qm.params, model.init_cache(cfg, LM_BATCH, max_len, device=dev))
    pctx = setup.pctx()
    step_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = model.prefill(params, cfg, batch, state, pctx=pctx)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    forced = [logits]
    for i in range(n - 1):
        t0 = time.perf_counter()
        logits, state = model.decode_step(params, cfg, new[:, i:i + 1], state, LM_PROMPT + i,
                                          pctx=pctx)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        forced.append(logits)
    tol = FAMILY_LOGIT_REL_TOL.get(arch, LM_LOGIT_REL_TOL)
    rel = _rel(forced, ref_logits)
    same = int((got == new).all(dim=1).sum())
    print(f"{tag}: teacher-forced on the meshless tokens, max |logit diff| / max |logit| "
          f"against the meshless kernels' {rel:.3e} (limit {tol:g}); rows identical to the "
          f"meshless tokens {same}/{LM_BATCH}; prefill ms {pre_ms:.2f}, decode ms a step median "
          f"{statistics.median(step_ms):.2f} (meshless {refs['prefill_ms']:.2f} and "
          f"{refs['decode_ms']:.2f}, one process alone)")
    if not rel <= tol:
        out["failures"].append(f"[tp] (e) {cfg.name} rank {rank}: logits {rel:.3e} against "
                               "the meshless")
    out["report"][arch] = {"logit_rel": rel, "rows_same": same, "prefill_ms": pre_ms,
                           "decode_ms_median": statistics.median(step_ms), "peak_bytes": peak,
                           "generate_s": gen_s}
    del params, state, forced, logits, ref_logits
    _tp_held(torch, dev, mesh, rank, f"{cfg.name} static_generate", tap, out)
    del qm, tap
    torch.cuda.empty_cache()


def _tp_family_train(torch, dev, mesh, rank, out) -> None:
    """(e) mamba2-780m at full width, TP_M2_TRAIN_LAYERS of its 48 layers, in
    float32 (where a loss within TP_TRAIN_REL_TOL is a float32 sum in another
    order, not a bf16 rounding): TP_M2_TRAIN_STEPS ``TrainSetup`` steps on one
    card without a mesh and then on the (1, 2) mesh, on the same seeded weights
    and batches; the losses and the gradient norms (where a gradient summed over
    the model axis once too often shows, as the losses barely do) within
    TP_TRAIN_REL_TOL relative, no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.models import get_model
    from repro_torch.runtime import collectives
    from repro_torch.runtime.train_loop import (
        TrainSetup,
        init_opt_state,
        local_params,
        make_train_step,
    )

    cfg = dataclasses.replace(get_config("mamba2_780m"), n_layers=TP_M2_TRAIN_LAYERS,
                              dtype_str="float32")
    ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    losses, gnorms, ms = {}, {}, {}
    for name, m in (("meshless", None), ("tp", mesh)):
        setup = TrainSetup(cfg=cfg, mesh=m, lr_peak=6e-4, warmup=0, total_steps=10, remat=True)
        whole = get_model(cfg).init_params(cfg, seed=3, device=dev)
        p, opt, step = local_params(setup, whole), init_opt_state(setup, whole), \
            make_train_step(setup)
        del whole
        collectives.reset()
        _zero_counts()
        losses[name], gnorms[name], times = [], [], []
        for i in range(TP_M2_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, _, mt = step(p, opt, None, shard_batch(ds.np_batch(i), m, device=dev))
            losses[name].append(float(mt["loss"]))
            gnorms[name].append(float(mt["gnorm"]))
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = times
        issued = dict(collectives.ISSUED)
        _no_kernel_launches(f"[tp] (e) rank {rank} mamba2-780m training {name}",
                            out["failures"])
        del p, opt
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["tp"], losses["meshless"]))
    g_rel = max(abs(a - b) / abs(b) for a, b in zip(gnorms["tp"], gnorms["meshless"]))
    print(f"[tp r{rank}] (e) mamba2-780m training, {TP_M2_TRAIN_LAYERS} of 48 layers, float32, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat: losses on (1, 2) {losses['tp']}, meshless "
          f"{losses['meshless']}, largest relative difference {rel:.3e} (limit "
          f"{TP_TRAIN_REL_TOL:g}); gradient norms on (1, 2) {gnorms['tp']}, meshless "
          f"{gnorms['meshless']}, largest relative difference {g_rel:.3e} (limit "
          f"{TP_TRAIN_REL_TOL:g}); step ms (1, 2) {[round(t, 1) for t in ms['tp']]}, meshless "
          f"{[round(t, 1) for t in ms['meshless']]}; collectives on (1, 2) {issued}")
    finite = all(math.isfinite(v) for run in (*losses.values(), *gnorms.values()) for v in run)
    if (not finite or not max(rel, g_rel) <= TP_TRAIN_REL_TOL or not issued["all_reduce"]
            or issued["reduce_scatter"]):
        out["failures"].append(f"[tp] (e) rank {rank} mamba2-780m training: loss {rel:.3e}, "
                               f"gradient norm {g_rel:.3e}, collectives {issued}")
    out["report"]["mamba2_train"] = {"loss_rel": rel, "gnorm_rel": g_rel, "losses": losses["tp"],
                                     "step_ms": ms, "issued": issued}


BENCH_DIR = os.path.join(ROOT, "build", "bench_smoke")
# Every phase but the bench phase dispatches on an empty autotune cache (a path
# that is never written): the heuristic, whatever an earlier tune left in build/.
EMPTY_CACHE = os.path.join(BENCH_DIR, "empty_autotune_cache.json")
# qwen3-8b's four distinct decode-step [K, N] (q and o, k and v, gate and up,
# down), a4 nibble codes, bf16 x, at the decode step's M and the engine's
# admissions (48-400 tokens); flash-decode at the cost phase's decode geometry.
BENCH_QWEN_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
BENCH_QWEN_MS = (16, 48, 128, 192, 256, 384)
BENCH_FLASH = (16, 4096, 32, 128, 8)  # slots, positions, heads, head dim, KV heads
BENCH_ITERS, BENCH_WARMUP = 2, 1  # (c)'s harness budget a measurement


def bench_phase(torch, dev, failures, mesh) -> None:
    """The port's ``bench/`` on the card, on a cache of its own under BENCH_DIR.

    (a) ``autotune.autotune_matmul`` at qwen3-8b's decode-step shapes
    (BENCH_QWEN_KN x BENCH_QWEN_MS, bf16 x: the wgmma routes) and at AlexNet's
    five im2col conv and three fc shapes at batch 64 (float32 x: the bf16x3
    routes), each impl the median of 7 cold-L2 launches; the M at which the
    measured winner turns from ``fused`` to ``tiled`` per [K, N] against
    MAX_FUSED_M; ``autotune_flash_decode`` at BENCH_FLASH on the (1, 1) mesh.
    (b) dispatch follows the cache: an entry electing the tiled kernel where the
    heuristic takes the decode-step one moves ``quantized_matmul(impl="auto")``'s
    launch (held against the plain version); flash-decode's ``block_s=None``
    equals the tuned chunk; ``api.quantize(ALEXNET, QuantScheme(block_sizes=
    "auto"))`` on the tuned cache against the default scheme on an empty one,
    logits within the CNN gate (float activations), the empty cache's launches
    the heuristic's. (c) ``python -m repro_torch.bench --smoke`` in this
    process, both documents validated and gated against themselves. The phase's
    launches are printed on a line of their own: they are no main path's."""
    from repro_torch import api
    from repro_torch.bench import __main__ as bench_cli
    from repro_torch.bench import autotune, schema
    from repro_torch.kernels import ops
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain
    from repro_torch.kernels.fused_decode import MAX_FUSED_M
    from repro_torch.models import cnn
    from repro_torch.models.context import ParallelCtx
    from repro_torch.models.flash_decode import flash_decode_attention

    t_phase = time.perf_counter()
    start = _counts()
    tuned_cache = os.path.join(BENCH_DIR, "autotune_cache.json")

    def use_cache(path):
        os.environ[autotune.CACHE_ENV] = path
        autotune.invalidate_memory_cache()

    use_cache(tuned_cache)
    try:
        # (a) tune at full width
        t0 = time.perf_counter()
        for (kdim, n) in BENCH_QWEN_KN:
            winners = []
            for m in BENCH_QWEN_MS:
                res = autotune.autotune_matmul(m, kdim, n, "elp_bsd_a4", nibble=True,
                                               dtype=torch.bfloat16, device=dev)
                _bench_row("qwen3-8b", m, kdim, n, res)
                winners.append((m, res["impl"]))
            flip = next((m for m, w in winners if w == "tiled"), None)
            print(f"[bench] (a) qwen3-8b K={kdim} N={n}: winners "
                  + ", ".join(f"M={m} {w}" for m, w in winners)
                  + f"; the measured winner turns fused -> tiled at M={flip} "
                  f"(MAX_FUSED_M = {MAX_FUSED_M}; fused runs up to it)")
        for g in gemm_shapes(cnn.ALEXNET):
            if g[0] == "conv":
                _, hw, cin, k, stride, cout = g
                m, kdim, n = BATCH * (-(-hw // stride)) ** 2, k * k * cin, cout
            else:
                m, (kdim, n) = BATCH, g[1:]
            res = autotune.autotune_matmul(m, kdim, n, "elp_bsd_a4", nibble=True,
                                           dtype=torch.float32, device=dev)
            _bench_row(f"AlexNet {g[0]}", m, kdim, n, res)
        b, s_len, h, hd, kv = BENCH_FLASH
        pctx = ParallelCtx(mesh=mesh, flash_decode=True)
        fres = autotune.autotune_flash_decode(b, s_len, h, hd, kv=kv, dtype=torch.bfloat16,
                                              pctx=pctx, device=dev)
        print(f"[bench] (a) flash-decode {b} slots x {h} heads x hd {hd} x {s_len} positions "
              f"(KV {kv}, bf16, (1, 1) mesh): "
              + ", ".join(f"block_s {r['block_s']} {r['wall_us'] / 1e3:.4f} ms"
                          for r in fres["ranking"])
              + f"; winner block_s {fres['blocks'][1]} (0 = one shot)")
        n_entries = len(autotune.cache_entries())
        print(f"[bench] (a) {len(BENCH_QWEN_KN) * len(BENCH_QWEN_MS) + 8} matmul shapes and 1 "
              f"flash shape tuned, {n_entries} cache entries, in {time.perf_counter() - t0:.1f} s")

        # (b) dispatch follows the cache
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(27)
        m, kdim, n = 16, 4096, 4096
        x = torch.randn(m, kdim, device=dev, generator=gen).to(torch.bfloat16)
        w = torch.randn(kdim, n, device=dev, generator=gen) * 0.02
        pw, _ = ops.pack_weight(w, "elp_bsd_a4")
        del w
        want = elp_bsd_matmul_plain(x, pw.codes, pw.sf, pw.fmt, nibble=True,
                                    out_dtype=torch.float32)
        limit = REL_TOL * want.abs().max().item()

        def dispatched(label, expect):
            before = _counts()
            got = ops.quantized_matmul(x, pw, impl="auto", out_dtype=torch.float32)
            torch.cuda.synchronize()
            delta = dict(zip(KERNEL_ROUTES, (a - c for a, c in zip(_counts(), before))))
            err = (got - want).abs().max().item()
            print(f"[bench] (b) {label}: impl=\"auto\" at M={m} K={kdim} N={n} launched "
                  f"{ {k: v for k, v in delta.items() if v} }; max_abs_err {err:.3e} "
                  f"(limit {limit:.3e})")
            if delta != dict(zip(KERNEL_ROUTES, _expected({expect: 1}))) or not err <= limit:
                failures.append(f"[bench] (b) {label}: launches {delta}, err {err:.3e}")

        key = lambda impl: autotune.cache_key(m, kdim, n, "elp_bsd_a4", True, "cuda", impl)  # noqa: E731
        autotune.write_entries({key("tiled"): {"blocks": list(autotune.DEFAULT_BLOCKS),
                                               "wall_us": 1.0},
                                key("fused"): {"blocks": list(autotune.DEFAULT_BLOCKS),
                                               "wall_us": 2.0}})
        dispatched("an entry electing the tiled kernel", "elp_bsd_matmul/wgmma")
        use_cache(EMPTY_CACHE)
        dispatched("the empty cache (heuristic: M <= 256)", "fused_decode_matmul/wgmma")
        use_cache(tuned_cache)

        # float32: the chunked and one-shot results then differ by float32 rounding
        # only, not by a bf16 step of the output
        q = torch.randn(b, 1, h, hd, device=dev, generator=gen)
        ck, cv = (torch.randn(b, s_len, kv, hd, device=dev, generator=gen) for _ in range(2))
        chunk = autotune.lookup_flash_block_s(b, h, hd, s_len, backend="cuda")
        got = flash_decode_attention(q, ck, cv, s_len - 1, pctx=pctx)
        tuned_out = flash_decode_attention(q, ck, cv, s_len - 1, pctx=pctx,
                                           block_s=fres["blocks"][1])
        one_shot = flash_decode_attention(q, ck, cv, s_len - 1, pctx=pctx, block_s=0)
        fd_err = (got - one_shot).abs().max().item()
        fd_limit = FLASH_DECODE_REL_TOL * one_shot.abs().max().item()
        same = bool(torch.equal(got, tuned_out))
        print(f"[bench] (b) flash-decode block_s=None looks up {chunk} (tuned "
              f"{fres['blocks'][1]}): equal to the tuned chunk's call {same}; against the "
              f"one-shot slice max_abs_err {fd_err:.3e} (limit {fd_limit:.3e})")
        if chunk != (fres["blocks"][1] or None) or not same or not fd_err <= fd_limit:
            failures.append(f"[bench] (b) flash-decode: lookup {chunk}, equal {same}, "
                            f"err {fd_err:.3e}")
        del q, ck, cv, got, tuned_out, one_shot, x, want

        params = cnn.init_params(cnn.ALEXNET, seed=0)
        images = torch.randn(BATCH, 224, 224, 3, device=dev, generator=gen)
        def forward(qm):
            before = _counts()
            logits = qm.forward(images)
            torch.cuda.synchronize()
            return logits, dict(zip(KERNEL_ROUTES, (a - c for a, c in zip(_counts(), before))))

        qm_auto = api.quantize(cnn.ALEXNET, params, api.QuantScheme(block_sizes="auto"))
        logits_auto, tuned_launches = forward(qm_auto)
        tuned_launches = {k: v for k, v in tuned_launches.items() if v}
        use_cache(EMPTY_CACHE)
        qm_default = api.quantize(cnn.ALEXNET, params, api.QuantScheme())
        logits_default, empty_launches = forward(qm_default)
        heuristic = dict(zip(KERNEL_ROUTES, _expected({"elp_bsd_matmul/bf16x3": 5,
                                                       "fused_decode_matmul/bf16x3": 3})))
        diff = (logits_auto - logits_default).abs().max().item()
        cnn_limit = FLOAT_LOGIT_REL_TOL * logits_default.abs().max().item()
        print(f"[bench] (b) ALEXNET b{BATCH}, QuantScheme(block_sizes=\"auto\") on the tuned "
              f"cache (launches {tuned_launches}, tuned_blocks {qm_auto.report.tuned_blocks}) "
              f"against the default scheme on the empty cache (launches "
              f"{ {k: v for k, v in empty_launches.items() if v} }): max_abs_diff {diff:.3e} "
              f"(limit {FLOAT_LOGIT_REL_TOL:g} * max|logit| = {cnn_limit:.3e})")
        if not diff <= cnn_limit or empty_launches != heuristic:
            failures.append(f"[bench] (b) ALEXNET auto blocks: diff {diff:.3e}, empty-cache "
                            f"launches {empty_launches}")
        del params, images, qm_auto, qm_default, logits_auto, logits_default
        torch.cuda.empty_cache()
        print(f"[bench] (b) {time.perf_counter() - t0:.1f} s")

        # (c) the smoke tier of both suites in this process, on the tuned cache
        use_cache(tuned_cache)
        t0 = time.perf_counter()
        out_dir = os.path.join(BENCH_DIR, "docs")
        rc = bench_cli.main(["--smoke", "--out-dir", out_dir, "--iters", str(BENCH_ITERS),
                             "--warmup", str(BENCH_WARMUP)])
        paths = [os.path.join(out_dir, bench_cli.bench_filename(s)) for s in schema.SUITES]
        docs = []
        for path in paths:
            with open(path) as f:
                docs.append(json.load(f))
            schema.validate(docs[-1])
        ratios = [r for doc in docs for r in bench_cli._collect_ratios(doc, doc, 200.0)]
        gate = bench_cli._gate(ratios, 0.20)
        print(f"[bench] (c) python -m repro_torch.bench --smoke: exit {rc}; "
              + "; ".join(f"{d['suite']} {len(d['entries'])} entries (backend {d['backend']}, "
                          f"torch {d['torch_version']})" for d in docs)
              + f"; validated; gated against itself: {len(ratios)} timings, "
              f"{len(gate)} failures; {time.perf_counter() - t0:.1f} s")
        for d in docs:
            for name, e in d["entries"].items():
                print(f"[bench] (c) {name}: "
                      + ", ".join(f"{k} {t['min_us']:.1f} us" + (f" ({t['impl']})"
                                                                 if "impl" in t else "")
                                  for k, t in e["wall_us"].items() if t))
        if rc != 0 or gate:
            failures.append(f"[bench] (c): exit {rc}, gate {gate}")
    finally:
        use_cache(EMPTY_CACHE)
    launches = {k: a - c for k, a, c in zip(KERNEL_ROUTES, _counts(), start)}
    print(f"[bench] launches of the bench phase (tuning, checks and the suites; no main "
          f"path's): { {k: v for k, v in launches.items() if v} }")
    print(f"[time] bench phase: {time.perf_counter() - t_phase:.1f} s")


def _bench_row(label, m, kdim, n, res) -> None:
    """Print one tuned shape: each impl's ms and the voting winner."""
    ms = {r["impl"]: r["wall_us"] / 1e3 for r in res["ranking"]}
    print(f"[bench] (a) {label} M={m} K={kdim} N={n} a4/nib ({res['route']} route): tiled "
          f"{ms['tiled']:.4f} ms, fused "
          + (f"{ms['fused']:.4f} ms" if "fused" in ms else "n/a (M > MAX_FUSED_M)")
          + f", library {ms['library']:.4f} ms; winner {res['impl']}")


def main() -> int:
    # One card: the run uses device 0 and its record says so.
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch import _build, api
    from repro_torch.bench.autotune import CACHE_ENV
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
    t_start = time.perf_counter()
    # what the phases hand the TP phase is this run's: nothing of an earlier run stays
    shutil.rmtree(TP_DIR, ignore_errors=True)
    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    os.environ[CACHE_ENV] = EMPTY_CACHE  # the TP ranks inherit it
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

    def case(name, lhs, pw, label, library=None, key=ALEXNET_B64):
        """``lhs @ pw`` on route ``name`` and on the float32 kernel it replaced,
        each against the plain version, at the inputs the main path gives it;
        with a ``library`` call, also time both, plain and library, and bound
        the work at these shapes at each route's arithmetic. ``key`` (spec
        name, batch, format) names the packed forwards that run this shape:
        their count weighs its times in the kernel record."""
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
        row = {"shape": f"{label} M={m} K={kdim} N={n}", "key": key}
        want = ref()
        row["max_abs_err"] = check(name, row["shape"], run(), want)
        if kernel.launches_by_route != {**before, route_name: before[route_name] + 1}:
            failures.append(f"{name} {label}: launches by route {kernel.launches_by_route}")
        f32_row = {"shape": row["shape"], "key": key,
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
    # The Sec. V slice's shapes: each conv/fc GEMM of the two mini CNNs at the
    # eval batch of 128 in each Table II format (Fig. 15(b); N = 10-32, K from
    # 27, code rows of 10 and 16 bytes), and of ALEXNET at 128 in a4 (the
    # full-width search's packed eval). Library as above.
    for spec_name, fmts in (("ALEXNET_MINI", FMT_NAMES), ("VGG_MINI", FMT_NAMES),
                            ("ALEXNET", ("elp_bsd_a4",))):
        spec = getattr(cnn, spec_name)
        for i, g in enumerate(gemm_shapes(spec)):
            if g[0] == "conv":
                _, hw, cin, k, stride, cout = g
                img = torch.randn(EVAL_BATCH, hw, hw, cin, device=dev, generator=gen)
                w = torch.randn(k, k, cin, cout, device=dev, generator=gen) / (k * math.sqrt(k))
                lhs = extract_patches(img, k, k, stride=stride).reshape(-1, k * k * cin)
                xi = pad_nhwc(img, k, k, stride, "SAME").permute(0, 3, 1, 2).contiguous()
                del img
            else:
                _, kdim, cout = g
                lhs = torch.relu(torch.randn(EVAL_BATCH, kdim, device=dev, generator=gen))
                w = torch.randn(kdim, cout, device=dev, generator=gen) / math.sqrt(kdim)
            for fmt_name in fmts:
                if g[0] == "conv":
                    pw, _ = ops.pack_conv_weight(w, fmt_name)
                    wq = ops.dequantize_nd(pw).permute(3, 2, 0, 1).contiguous()
                    library = lambda: F.conv2d(xi, wq, stride=stride).permute(0, 2, 3, 1)  # noqa: E731
                    name = "elp_bsd_matmul/bf16x3"
                else:
                    pw, _ = ops.pack_weight(w, fmt_name)
                    wq = ops.dequantize(pw)
                    library = lambda: torch.matmul(lhs, wq)  # noqa: E731
                    name = "fused_decode_matmul/bf16x3"
                case(name, lhs, pw, f"{spec.name} b{EVAL_BATCH} {g[0]}{i} {fmt_name}", library,
                     key=(spec.name, EVAL_BATCH, fmt_name))
            del lhs, w
            xi = None
    torch.cuda.empty_cache()
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
        tot = {k: sum(r[k] for r in rows[name] if r["key"] == ALEXNET_B64)
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
    print(f"[time] phases 1-4 (card, build, kernels, AlexNet main path): "
          f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 4b: the Sec. V slice: mini CNNs, Fig. 15(a)/(b), the search, artifacts --
    forwards = collections.Counter({ALEXNET_B64: 1})
    t0 = time.perf_counter()
    trained, sec5_launches = mini_phase(torch, dev, failures, forwards)
    print(f"[time] phase 4b(a), mini CNNs and Fig. 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    c = quickstart_phase(torch, dev, trained["ALEXNET_MINI"], failures, forwards)
    sec5_launches = tuple(a + b for a, b in zip(sec5_launches, c))
    print(f"[time] phase 4b(b), the quickstart flow: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paper_launches = dict(zip(KERNEL_ROUTES, paper_results_phase(torch, dev, trained, failures,
                                                                 forwards)))
    print(f"[time] phase 4b(d), the paper's remaining results: {time.perf_counter() - t0:.1f} s")
    del trained
    t0 = time.perf_counter()
    c = full_search_phase(torch, dev, failures, forwards)
    sec5_launches = dict(zip(KERNEL_ROUTES, (a + b for a, b in zip(sec5_launches, c))))
    print(f"[time] phase 4b(c), the full-width search: {time.perf_counter() - t0:.1f} s; "
          f"launches of the Sec. V phases {sec5_launches}")
    t0 = time.perf_counter()
    bf16x3_k_sweep(torch, dev, gen, failures)
    torch.cuda.empty_cache()
    print(f"[time] bf16x3 K sweep: {time.perf_counter() - t0:.1f} s")

    # -- phase 5: the LM path's kernels at its shapes ------------------------------
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    # each AlexNet-path shape runs once per forward, each Sec. V shape once per
    # packed forward of its (spec, batch, format); the f32 routes are timed at
    # the AlexNet path's shapes only (launched directly, on no path)
    for name in ("elp_bsd_matmul/bf16x3", "fused_decode_matmul/bf16x3"):
        for r in rows[name]:
            r["weight"] = forwards[r["key"]]
    for name in ("elp_bsd_matmul/f32", "fused_decode_matmul/f32"):
        for r in rows[name]:
            r["weight"] = 1 if r["key"] == ALEXNET_B64 else 0
    lm_kernel_phase(torch, dev, gen, flush, rows, failures)
    del flush
    torch.cuda.empty_cache()

    # -- phase 6: the LM main path, and phase 7: its kernels held on the card -----
    # -- the mesh phase: a one-rank NCCL group and the (1, 1) mesh over it -----------
    from repro_torch.runtime.elastic import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh()
    mesh_report = {}
    print(f"[mesh] {mesh} on the {torch.distributed.get_backend()} backend, world "
          f"{torch.distributed.get_world_size()}, in {time.perf_counter() - t0:.1f} s")
    lm_launches, engine_launches = lm_main_path(torch, dev, failures, rows, mesh, mesh_report)

    # -- phase 7b: the MoE family (olmoe-1b-7b) and the VLM stub (internvl2-26b) ----
    moe_launches = moe_phase(torch, dev, failures, rows, mesh, mesh_report)
    vlm_launches = vlm_phase(torch, dev, failures, rows)

    # -- phase 7c: the recurrent and enc-dec families -------------------------------
    family_launches = collections.Counter()
    for arch in FAMILY_ARCHS:
        family_launches.update(family_phase(torch, dev, failures, rows, arch))

    # -- phase 8: the reduced LM on the card against the CPU -----------------------
    lm_card_vs_cpu(torch, dev, failures)

    # -- phase 8b: full-width VGG16, the paper's second network --------------------
    # (after the engine phase, whose check counts every tapped row so far)
    t0 = time.perf_counter()
    vgg_launches = vgg16_phase(torch, dev, failures, rows)
    print(f"[time] phase 8b, VGG16: {time.perf_counter() - t0:.1f} s")

    # -- phase 9: LM training on one card, and lm_ptq ------------------------------
    t0 = time.perf_counter()
    train_phase(torch, dev, failures)
    print(f"[time] phase 9, training: {time.perf_counter() - t0:.1f} s")
    straight = mesh_train_phase(torch, dev, failures, mesh, mesh_report)
    mesh_collective_phase(torch, dev, failures, mesh, mesh_report)
    # -- the TP phase: two ranks on the card over gloo, a (1, 2) mesh ----------------
    tp_launches = tp_phase(torch, failures, rows, straight)
    # -- the cost phase: the dry-run and step-cost tooling, and the examples --------
    cost_launches = cost_phase(torch, dev, failures, rows, mesh)
    # -- the bench phase: the autotuner, dispatch on its cache, the smoke suites -----
    bench_phase(torch, dev, failures, mesh)
    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    # (e) the collectives issued by each part of the mesh phase
    mesh_launches = collections.Counter()
    for label, rec in mesh_report.items():
        mesh_launches.update(rec["launches"])
        print(f"[mesh] (e) {label}: collectives {rec['issued']}, {rec['s']:.1f} s")
    print(f"[mesh] (e) launches of the mesh phase by route "
          f"{ {k: mesh_launches[k] for k in KERNEL_ROUTES} }; "
          f"{sum(r['s'] for r in mesh_report.values()):.1f} s in all")
    if len(mesh_report) != 5:
        failures.append(f"[mesh] parts that ran: {sorted(mesh_report)}")
    torch.distributed.destroy_process_group()
    t0 = time.perf_counter()
    lm_ptq_phase(torch, dev, failures)
    print(f"[time] phase 9b, lm_ptq: {time.perf_counter() - t0:.1f} s")
    print(f"[time] total {time.perf_counter() - t_start:.1f} s")

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
            "launches": (cnn_launches.get(name, 0) + lm_launches[name] + sec5_launches[name]
                         + engine_launches[name] + moe_launches[name] + vlm_launches[name]
                         + family_launches[name] + vgg_launches[name] + paper_launches[name]
                         + mesh_launches[name] + tp_launches[name] + cost_launches[name]),
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
