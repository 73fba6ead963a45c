"""Deterministic benchmark workloads over the port's packed execution paths.

The JAX package's ``repro/bench/workloads.py``: the same names, tiers,
tags, ``shape`` blocks and ``autotune_shape`` s. Every spec pins its
shapes and seeds at registration (data from numpy generators), so two runs
of a tier give the same entry names, shape blocks, byte counts and quality
numbers; only the times vary.

Suites:

``kernels``: single packed ops.
  * ``matmul/<fmt>/<mode>/MxKxN``: the mini nets' fc shapes and an LM
    decode-step GEMM: the tiled kernel, the library call (the dequantized
    weight times ``torch.matmul``) and the ``impl="auto"`` dispatch; the
    output error of the dequantized product against the float one; the
    weight's bytes against bf16.
  * ``decode_step_fused/<fmt>/<mode>/4x2048x2048``: the decode-step kernel
    against the dequantize-then-matmul form and the tiled kernel.
  * ``conv2d/<net>/conv<i>/<fmt>/bB``: packed convs at the minis' layer
    shapes (im2col into the kernels) against cuDNN on the dequantized weight.

``e2e``: whole forwards.
  * ``cnn_fwd/<net>/<variant>/bB``: float, packed, dynamic and calibrated
    static activation quantization.
  * ``lm_decode/<arch>/<quant>/bBsS``: the decode step of the reduced model.
  * ``serve_continuous/...`` and ``serve_speculative/...``: the engine
    against static batching, paged int8, ngram and model drafts.

``wall_us`` keys map the reference's impl names: ``pallas`` -> ``tiled``,
``pallas_fused`` -> ``fused``, ``xla`` -> ``library``; the forwards of the
e2e suite, which the reference keys ``xla``, run the port's default
dispatch and are keyed ``auto``. ``selected`` is the ``impl="auto"``
dispatch of a kernel workload, its ``impl`` the kernel the dispatch took.
The reference's interpret-mode grid cap has no counterpart: on the CPU the
kernels run their plain versions at any size. ``hlo`` counts one call of
the port's own path with :func:`repro_torch.bench.harness.hlo_cost`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.bench import harness
from repro_torch.bench.registry import WorkloadSpec, register


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _seeded(rng: np.random.Generator, shape, device, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# Layer shapes from the CNN specs
# ---------------------------------------------------------------------------
def conv_layer_shapes(spec) -> list[tuple[int, object, int, int]]:
    """``[(layer_idx, Conv, input_hw, input_ch), ...]`` walking the spec."""
    from repro_torch.models import cnn

    out = []
    hw, ch, idx = spec.input_hw, spec.input_ch, 0
    for layer in spec.layers:
        if isinstance(layer, cnn.Conv):
            out.append((idx, layer, hw, ch))
            hw //= layer.stride
            ch = layer.ch
            idx += 1
        elif isinstance(layer, cnn.Pool):
            hw //= layer.stride
        elif isinstance(layer, cnn.Fc):
            idx += 1
    return out


def fc_layer_shapes(spec) -> list[tuple[int, int, int]]:
    """``[(layer_idx, fan_in, fan_out), ...]`` for the fc layers."""
    from repro_torch.models import cnn

    out = []
    hw, ch, idx = spec.input_hw, spec.input_ch, 0
    flat = None
    for layer in spec.layers:
        if isinstance(layer, cnn.Conv):
            hw //= layer.stride
            ch = layer.ch
            idx += 1
        elif isinstance(layer, cnn.Pool):
            hw //= layer.stride
        elif isinstance(layer, cnn.Fc):
            fan_in = flat if flat is not None else hw * hw * ch
            out.append((idx, fan_in, layer.out))
            flat = layer.out
            idx += 1
    return out


# ---------------------------------------------------------------------------
# kernels suite
# ---------------------------------------------------------------------------
def _library(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The library call: ``x`` times the dequantized weight (float32, no TF32)."""
    from repro_torch.device import full_f32

    with full_f32():
        return torch.matmul(x, wq)


def _time_selected(fn, m: int, pw, iters: int, warmup: int, device) -> dict:
    """The ``selected`` timing of the ``impl="auto"`` dispatch, with ``"impl"`` the
    kernel it took, so a change of the cache's winner shows in the entry, not as a
    time."""
    from repro_torch.kernels.ops import resolve_impl

    sel, _ = resolve_impl(m, pw, device.type)
    return {**harness.time_fn(fn, iters=iters, warmup=warmup, device=device).to_json(),
            "impl": sel}


def _weight_bytes(pw, k: int, n: int) -> dict:
    bf16_bytes = k * n * 2
    return {"weight_bytes": pw.nbytes + pw.sf.numel() * 4, "bf16_bytes": bf16_bytes,
            "hbm_weight_ratio": round(bf16_bytes / pw.nbytes, 3)}


def _run_matmul(m, k, n, fmt_name, nibble, iters, warmup, device):
    from repro_torch.kernels.ops import dequantize, pack_weight, quantized_matmul

    rng = np.random.default_rng(7)
    x = _seeded(rng, (m, k), device)
    w = _seeded(rng, (k, n), device, 0.02)
    pw, _ = pack_weight(w, fmt_name, compensate=True, nibble=nibble)
    wq = dequantize(pw)
    with torch.no_grad():
        tk = dict(iters=iters, warmup=warmup, device=device)
        wall = {
            "library": harness.time_fn(lambda: _library(x, wq), **tk).to_json(),
            "tiled": harness.time_fn(
                lambda: quantized_matmul(x, pw, impl="tiled", block_sizes="auto"), **tk).to_json(),
            "selected": _time_selected(
                lambda: quantized_matmul(x, pw, impl="auto", block_sizes="auto"), m, pw, iters,
                warmup, device),
        }
        return {
            "workload": "matmul",
            "shape": {"m": m, "k": k, "n": n, "fmt": fmt_name, "nibble": int(nibble)},
            "wall_us": wall,
            "hlo": harness.hlo_cost(lambda a, p: quantized_matmul(a, p, impl="auto"), x, pw),
            "quality": {"out_mse": harness.output_mse(_library(x, wq), _library(x, w))},
            "bytes": _weight_bytes(pw, k, n),
        }


def _run_decode_step_fused(m, k, n, fmt_name, nibble, iters, warmup, device):
    """Decode-step GEMM: the decode-step kernel (``fused``) against the
    dequantize-then-matmul form (``dequant``, the library call on a weight
    dequantized inside the timed call) and the tiled kernel (``tiled``, the
    reference's ``pallas`` key); ``selected`` is the auto dispatch. Quality
    records each kernel's largest distance from the dequantized product."""
    from repro_torch.kernels.ops import dequantize, pack_weight, quantized_matmul

    rng = np.random.default_rng(13)
    x = _seeded(rng, (m, k), device)
    w = _seeded(rng, (k, n), device, 0.02)
    pw, _ = pack_weight(w, fmt_name, compensate=True, nibble=nibble)
    tk = dict(iters=iters, warmup=warmup, device=device)

    def dequant_fn():
        return _library(x, dequantize(pw))

    def fused_fn():
        return quantized_matmul(x, pw, impl="fused")

    def tiled_fn():
        return quantized_matmul(x, pw, impl="tiled")

    with torch.no_grad():
        wall = {
            "dequant": harness.time_fn(dequant_fn, **tk).to_json(),
            "fused": harness.time_fn(fused_fn, **tk).to_json(),
            "tiled": harness.time_fn(tiled_fn, **tk).to_json(),
            "selected": _time_selected(
                lambda: quantized_matmul(x, pw, impl="auto", block_sizes="auto"), m, pw, iters,
                warmup, device),
        }
        ref = dequant_fn()
        return {
            "workload": "decode_step_fused",
            "shape": {"m": m, "k": k, "n": n, "fmt": fmt_name, "nibble": int(pw.nibble)},
            "wall_us": wall,
            "hlo": harness.hlo_cost(lambda a, p: quantized_matmul(a, p, impl="fused"), x, pw),
            "quality": {
                "fused_max_abs_diff": (fused_fn() - ref).abs().max().item(),
                "kernel_max_abs_diff": (tiled_fn() - ref).abs().max().item(),
                "out_mse": harness.output_mse(ref, _library(x, w)),
            },
            "bytes": _weight_bytes(pw, k, n),
        }


def _run_conv2d(net, idx, layer_k, stride, batch, hw, cin, cout, fmt_name, iters, warmup,
                device):
    from repro_torch.kernels.conv import conv2d_nhwc, quantized_conv2d
    from repro_torch.kernels.ops import dequantize_nd, pack_conv_weight

    rng = np.random.default_rng(11)
    x = _seeded(rng, (batch, hw, hw, cin), device)
    w = _seeded(rng, (layer_k, layer_k, cin, cout), device, 0.05)
    pw, _ = pack_conv_weight(w, fmt_name, compensate=True)
    wq = dequantize_nd(pw)
    m_im2col = batch * _ceil_div(hw, stride) ** 2
    tk = dict(iters=iters, warmup=warmup, device=device)

    def library_fn():
        return conv2d_nhwc(x, wq, stride=stride)

    with torch.no_grad():
        wall = {
            "library": harness.time_fn(library_fn, **tk).to_json(),
            "tiled": harness.time_fn(
                lambda: quantized_conv2d(x, pw, stride=stride, impl="tiled", block_sizes="auto"),
                **tk).to_json(),
            "selected": _time_selected(
                lambda: quantized_conv2d(x, pw, stride=stride, impl="auto"), m_im2col, pw, iters,
                warmup, device),
        }
        return {
            "workload": "conv2d",
            "shape": {"net": net, "layer": idx, "batch": batch, "hw": hw, "cin": cin,
                      "cout": cout, "ksize": layer_k, "stride": stride, "fmt": fmt_name},
            "wall_us": wall,
            "hlo": harness.hlo_cost(
                lambda a, p: quantized_conv2d(a, p, stride=stride, impl="auto"), x, pw),
            "quality": {"out_mse": harness.output_mse(library_fn(),
                                                      conv2d_nhwc(x, w, stride=stride))},
            "bytes": {"weight_bytes": pw.nbytes + pw.sf.numel() * 4, "f32_bytes": w.numel() * 4},
        }


def _register_kernel_suite() -> None:
    from repro_torch.models import cnn

    # Packed matmuls: the mini nets' fc layers (smoke at batch 8, full at
    # 128) plus an LM decode-step GEMM shape.
    matmuls = []
    for spec in (cnn.ALEXNET_MINI, cnn.VGG_MINI):
        for _, fan_in, fan_out in fc_layer_shapes(spec):
            matmuls.append(("smoke", 8, fan_in, fan_out))
            matmuls.append(("full", 128, fan_in, fan_out))
    matmuls.append(("full", 4, 2048, 2048))
    seen = set()
    for tier, m, k, n in matmuls:
        for fmt_name, nibble in (("elp_bsd_a4", True), ("elp_bsd_c6", False)):
            mode = "nib" if nibble else "u8"
            name = f"matmul/{fmt_name}/{mode}/{m}x{k}x{n}"
            if name in seen:
                continue
            seen.add(name)
            register(WorkloadSpec(
                name=name, suite="kernels", tier=tier,
                run=functools.partial(_run_matmul, m, k, n, fmt_name, nibble),
                tags=("matmul", fmt_name), autotune_shape=(m, k, n, fmt_name, nibble)))

    # Decode-step GEMMs: the serving hot path (small M, whole K x N).
    for fmt_name, nibble in (("elp_bsd_a4", True), ("elp_bsd_a4", False), ("elp_bsd_c6", False)):
        mode = "nib" if nibble else "u8"
        register(WorkloadSpec(
            name=f"decode_step_fused/{fmt_name}/{mode}/4x2048x2048", suite="kernels",
            tier="smoke",
            run=functools.partial(_run_decode_step_fused, 4, 2048, 2048, fmt_name, nibble),
            tags=("decode_step_fused", "matmul", fmt_name),
            autotune_shape=(4, 2048, 2048, fmt_name, nibble)))

    # Packed convs: every conv layer of both mini nets, a4 nibble, smoke at
    # batch 2, full at batch 32.
    for spec in (cnn.ALEXNET_MINI, cnn.VGG_MINI):
        for idx, layer, hw, cin in conv_layer_shapes(spec):
            for tier, batch in (("smoke", 2), ("full", 32)):
                m_im2col = batch * _ceil_div(hw, layer.stride) ** 2
                register(WorkloadSpec(
                    name=f"conv2d/{spec.name}/conv{idx}/elp_bsd_a4/b{batch}", suite="kernels",
                    tier=tier,
                    run=functools.partial(_run_conv2d, spec.name, idx, layer.k, layer.stride,
                                          batch, hw, cin, layer.ch, "elp_bsd_a4"),
                    tags=("conv2d", spec.name),
                    autotune_shape=(m_im2col, layer.k * layer.k * cin, layer.ch, "elp_bsd_a4",
                                    True)))


# ---------------------------------------------------------------------------
# e2e suite
# ---------------------------------------------------------------------------
def _run_cnn_fwd(spec_name, batch, variant, iters, warmup, device):
    from repro_torch import api
    from repro_torch.models import cnn

    spec = {"alexnet_mini": cnn.ALEXNET_MINI, "vgg_mini": cnn.VGG_MINI}[spec_name]
    params = cnn.init_params(spec, seed=0, device=device)
    rng = np.random.default_rng(3)
    x = _seeded(rng, (batch, spec.input_hw, spec.input_hw, spec.input_ch), device)
    quality: dict = {}
    bytes_blk = None

    if variant == "float":
        def fwd(p, a):
            return cnn.forward(p, spec, a)
        run_params = params
    else:
        float_logits = cnn.forward(params, spec, x)
        if variant == "packed":
            qm = api.quantize(spec, params, api.QuantScheme(fmt="elp_bsd_a4"), device=device)

            def fwd(p, a):
                return cnn.forward(p, spec, a, impl="auto", block_sizes="auto")
        elif variant == "packed_dynamic_act":
            qm = api.quantize(spec, params,
                              api.QuantScheme(fmt="elp_bsd_a4", act="dynamic", act_bits=8),
                              device=device)

            def fwd(p, a):
                return cnn.forward(p, spec, a, act_bits=8)
        elif variant == "packed_calib":
            images = _seeded(np.random.default_rng(5),
                             (4, batch, spec.input_hw, spec.input_hw, spec.input_ch), device)
            qm = api.quantize(spec, params,
                              api.QuantScheme(fmt="elp_bsd_a4", act="static", act_bits=8),
                              calib_data=images, device=device)
            table = qm.table

            def fwd(p, a):
                return cnn.forward(p, spec, a, calib=table)
        else:
            raise ValueError(f"unknown cnn_fwd variant {variant!r}")
        run_params = qm.params
        pw_bytes = qm.report.packed_weight_bytes
        f32_bytes = sum(w.numel() * 4 for k, w in params.items() if k.endswith("_w"))
        bytes_blk = {"weight_bytes": pw_bytes, "f32_bytes": f32_bytes,
                     "compression": round(f32_bytes / pw_bytes, 3)}
        quality["logits_mse"] = harness.output_mse(fwd(run_params, x), float_logits)

    with torch.no_grad():
        wall = {"auto": harness.time_fn(lambda: fwd(run_params, x), iters=iters, warmup=warmup,
                                        device=device).to_json()}
        hlo = harness.hlo_cost(fwd, run_params, x)
    return {
        "workload": "cnn_fwd",
        "shape": {"net": spec_name, "batch": batch, "hw": spec.input_hw, "variant": variant},
        "wall_us": wall,
        "hlo": hlo,
        "quality": quality or None,
        "bytes": bytes_blk,
    }


def _run_lm_decode(arch, quant, batch, prompt_len, iters, warmup, device):
    from repro_torch import api as front
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LmDataset
    from repro_torch.models import get_model
    from repro_torch.runtime.quantized_params import packed_bytes

    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    params = model.init_params(cfg, 0, device=device)
    float_bytes = packed_bytes(params)
    if quant != "float":
        params = front.quantize(cfg, params, front.QuantScheme(fmt=quant), device=device).params
    max_len = prompt_len + 8
    batch_np = LmDataset(cfg, seq_len=prompt_len, batch=batch, seed=7).np_batch(0)
    tokens = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items() if k != "labels"}
    cache = model.init_cache(cfg, batch, max_len, device=device)
    with torch.no_grad():
        logits, cache = model.prefill(params, cfg, tokens, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

        def decode(p, t, c, pos):
            return model.decode_step(p, cfg, t, c, pos)

        wall = {"auto": harness.time_fn(lambda: decode(params, tok, cache, prompt_len),
                                        iters=iters, warmup=warmup, device=device).to_json()}
        hlo = harness.hlo_cost(decode, params, tok, cache, prompt_len)
    return {
        "workload": "lm_decode",
        "shape": {"arch": arch, "quant": quant, "batch": batch, "prompt_len": prompt_len},
        "wall_us": wall,
        "hlo": hlo,
        "quality": None,
        "bytes": {"weight_bytes": packed_bytes(params), "float_bytes": float_bytes},
    }


def _serve_bench_cfg():
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="serve_bench", family="dense", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab=256, head_dim=32, dtype_str="float32")


def _serve_trace(n_requests: int):
    """Deterministic mixed-length staggered trace: (prompt_len, max_new,
    arrival_step), short/medium/long prompts with varied budgets, the shape
    static padded batching is worst at."""
    pattern = [(8, 24, 0), (32, 12, 0), (96, 8, 0), (8, 24, 1), (32, 8, 3), (8, 16, 5)]
    out = []
    for i in range(n_requests):
        s, n, a = pattern[i % len(pattern)]
        out.append((s, n, a + 6 * (i // len(pattern))))
    return out


def _hlo_keys(cost: dict) -> dict:
    return {k: cost[k] for k in ("flops", "bytes_accessed", "collective_bytes")}


def _static_ref(cfg, params, prompt, n, device, kv_scales=None) -> np.ndarray:
    """Per-request, unpadded static generation: the engines' token reference."""
    from repro_torch.serve.engine import ServeSetup, static_generate

    setup = ServeSetup(cfg=cfg, mesh=None, max_len=prompt.size + n, batch=1)
    feed = {"tokens": torch.from_numpy(prompt[None]).to(device)}
    return static_generate(setup, params, feed, n, kv_scales=kv_scales)[0].cpu().numpy()


def _run_serve_continuous(quant, n_slots, n_requests, iters, warmup, device):
    from repro_torch import api as front
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.core.energy import lm_cache_bytes_per_token
    from repro_torch.models import get_model
    from repro_torch.obs.metrics import Registry
    from repro_torch.runtime.quantized_params import packed_bytes
    from repro_torch.serve.engine import ServeEngine, ServeSetup, build_serve_fns

    cfg = _serve_bench_cfg()
    model = get_model(cfg)
    params = model.init_params(cfg, 0, device=device)
    float_params = params  # the KV-scale calibration taps the float forward
    float_bytes = packed_bytes(params)
    if quant != "float":
        params = front.quantize(cfg, params, front.QuantScheme(fmt=quant), device=device).params

    rng = np.random.default_rng(13)
    trace = _serve_trace(n_requests)
    reqs = [(rng.integers(0, cfg.vocab, size=s).astype(np.int32), n) for s, n, _ in trace]
    arrivals = [a for _, _, a in trace]
    max_len = 128
    useful_tokens = sum(n for _, n in reqs)

    engine = ServeEngine(cfg, params, n_slots=n_slots, max_len=max_len, mesh=None)
    engine_m = ServeEngine(cfg, params, n_slots=n_slots, max_len=max_len, mesh=None,
                           metrics=Registry(enabled=True))

    # Static padded-batch baseline: requests grouped in arrival order, prompts
    # padded to the group's longest, every row decoding the group's largest
    # budget; the step pair built once per group, outside the timed call.
    static_groups = []
    for i in range(0, len(reqs), n_slots):
        g = reqs[i: i + n_slots]
        smax = max(t.size for t, _ in g)
        nmax = max(n for _, n in g)
        toks = np.zeros((len(g), smax), np.int32)
        for r, (t, _) in enumerate(g):
            toks[r, : t.size] = t
        setup = ServeSetup(cfg=cfg, mesh=None, max_len=smax + nmax, batch=len(g))
        pj, dj = build_serve_fns(setup, model)
        static_groups.append((setup, pj, dj, torch.from_numpy(toks).to(device), nmax))

    def static_fn():
        tok = None
        for setup, pj, dj, toks, nmax in static_groups:
            cache = model.init_cache(cfg, toks.shape[0], setup.max_len, device=device)
            logits, cache = pj(params, {"tokens": toks}, cache)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            pos = toks.shape[1]
            for j in range(nmax - 1):
                logits, cache = dj(params, tok, cache, pos + j)
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return tok

    tk = dict(iters=iters, warmup=warmup, device=device)
    with torch.no_grad():
        # interleaved: the recorded number is the metrics/plain RATIO
        t_cont, t_metrics = harness.time_fn_pair(
            lambda: engine.serve(reqs, arrivals=arrivals),
            lambda: engine_m.serve(reqs, arrivals=arrivals), **tk)
        t_static = harness.time_fn(static_fn, **tk)

    # Continuous output against per-request static generation.
    outs = engine.serve(reqs, arrivals=arrivals)
    matched = total = 0
    for (prompt, n), out in zip(reqs, outs):
        matched += int(np.sum(_static_ref(cfg, params, prompt, n, device) == out))
        total += n
    tok_s_cont = useful_tokens / (t_cont.min_us * 1e-6)
    tok_s_metrics = useful_tokens / (t_metrics.min_us * 1e-6)
    tok_s_static = useful_tokens / (t_static.min_us * 1e-6)
    energy = harness.lm_token_energy(cfg, params)

    # Paged int8 KV cache on a shared-system-prefix trace, against the
    # dense-layout static int8 reference with the same calibrated scales.
    calib_toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, (2, 2, 64)).astype(np.int64)).to(device)
    kv_scales = calibrate_kv_cache(float_params, cfg, calib_toks)
    sys_prefix = rng.integers(0, cfg.vocab, 32).astype(np.int32)
    paged_reqs = []
    for i in range(min(n_requests, 8)):
        suffix = rng.integers(0, cfg.vocab, 4 + (3 * i) % 24)
        paged_reqs.append((np.concatenate([sys_prefix, suffix]).astype(np.int32), 12))
    scales = tuple(torch.as_tensor(s, device=device) for s in kv_scales)
    refs = [_static_ref(cfg, params, prompt, n, device, kv_scales=scales)
            for prompt, n in paged_reqs]
    p_matched = p_total = 0
    paged_stats = None
    for flash in (False, True):
        eng = ServeEngine(cfg, params, n_slots=n_slots, max_len=max_len, mesh=None,
                          kv_cache="paged", page_size=16, kv_scales=kv_scales,
                          flash_decode=flash)
        for ref, out in zip(refs, eng.serve(paged_reqs)):
            p_matched += int(np.sum(ref == np.asarray(out)))
            p_total += ref.size
        paged_stats = eng.cache_stats()
    dense_float_slot = lm_cache_bytes_per_token(cfg, max_len)

    return {
        "workload": "serve_continuous",
        "shape": {"arch": cfg.name, "quant": quant, "n_slots": n_slots,
                  "n_requests": n_requests, "max_len": max_len, "useful_tokens": useful_tokens},
        "wall_us": {"continuous": t_cont.to_json(), "metrics": t_metrics.to_json(),
                    "static": t_static.to_json()},
        "hlo": _hlo_keys(engine.decode_cost()),
        "quality": {
            "tokens_per_s_continuous": round(tok_s_cont, 1),
            "tokens_per_s_metrics": round(tok_s_metrics, 1),
            "metrics_overhead_frac": round(t_metrics.min_us / t_cont.min_us - 1.0, 4),
            "tokens_per_s_static": round(tok_s_static, 1),
            "speedup_vs_static": round(tok_s_cont / tok_s_static, 3),
            "token_match_frac": round(matched / total, 4),
            "energy_nj_per_token": round(energy["total_nj"], 2),
            "energy_compute_nj_per_token": round(energy["compute_nj"], 2),
            "energy_memory_nj_per_token": round(energy["memory_nj"], 2),
            "cache_bytes_per_token": paged_stats["bytes_per_token"],
            "cache_bytes_per_token_dense_float": dense_float_slot,
            "cache_slot_bytes_paged": round(paged_stats["slot_bytes"], 1),
            "max_slots_at_fixed_mem": int(
                n_slots * dense_float_slot // max(paged_stats["slot_bytes"], 1.0)),
            "token_match_frac_paged": round(p_matched / p_total, 4),
        },
        "bytes": {"weight_bytes": packed_bytes(params), "float_bytes": float_bytes},
    }


def _spec_trace(n_requests: int):
    """Generation-heavy staggered trace: short prompts, large budgets,
    overlapping arrivals (decode-dominated, the regime speculation targets)."""
    pattern = [(8, 96, 0), (8, 88, 0), (8, 100, 1), (16, 80, 2), (8, 96, 3), (8, 88, 4)]
    out = []
    for i in range(n_requests):
        s, n, a = pattern[i % len(pattern)]
        out.append((s, n, a + 4 * (i // len(pattern))))
    return out


def _run_serve_speculative(spec_k, n_slots, n_requests, iters, warmup, device):
    from repro_torch import api as front
    from repro_torch.runtime.quantized_params import packed_bytes
    from repro_torch.runtime.train_loop import TrainSetup, train
    from repro_torch.serve.engine import ServeEngine

    cfg = _serve_bench_cfg()
    # Drafts pay only when they agree with the verify tier, and a random
    # net's argmax is chaotic under any perturbation: train the tiny model
    # briefly (fixed seed, synthetic stream) first.
    train_steps = 200
    params = train(
        TrainSetup(cfg=cfg, mesh=None, lr_peak=3e-3, warmup=20, total_steps=train_steps,
                   remat=False),
        steps=train_steps, batch_size=16, seq_len=64, log_every=10_000,
        log_fn=lambda _s: None, device=device,
    )["params"]
    qm = front.quantize(cfg, params, front.QuantScheme.speculative(draft="elp4", K=spec_k),
                        device=device)

    rng = np.random.default_rng(13)
    trace = _spec_trace(n_requests)
    reqs = [(rng.integers(0, cfg.vocab, size=s).astype(np.int32), n) for s, n, _ in trace]
    arrivals = [a for _, _, a in trace]
    max_len = 128
    useful_tokens = sum(n for _, n in reqs)

    # Headline: the ngram drafter (free host lookups, one wide verify a
    # round); recorded beside it, the elp4 model drafter.
    ngram_eng = ServeEngine(cfg, qm.verify_params, n_slots=n_slots, max_len=max_len, mesh=None,
                            spec_k=spec_k, spec_draft="ngram")
    model_eng = ServeEngine(cfg, qm.verify_params, n_slots=n_slots, max_len=max_len, mesh=None,
                            draft_params=qm.params, spec_k=spec_k)
    base_eng = ServeEngine(cfg, qm.verify_params, n_slots=n_slots, max_len=max_len, mesh=None)

    tk = dict(iters=iters, warmup=warmup, device=device)
    with torch.no_grad():
        t_spec = harness.time_fn(lambda: ngram_eng.serve(reqs, arrivals=arrivals), **tk)
        t_model = harness.time_fn(lambda: model_eng.serve(reqs, arrivals=arrivals), **tk)
        t_base = harness.time_fn(lambda: base_eng.serve(reqs, arrivals=arrivals), **tk)

    # Both speculative engines' tokens against static generation on the
    # verify tier: the output contract, whatever the drafter.
    matched = total = 0
    for eng in (ngram_eng, model_eng):
        for (prompt, n), out in zip(reqs, eng.serve(reqs, arrivals=arrivals)):
            matched += int(np.sum(_static_ref(cfg, qm.verify_params, prompt, n, device) == out))
            total += n
    ngram_stats = ngram_eng.stats()["speculative"]
    model_stats = model_eng.stats()["speculative"]
    acc_rate = ngram_stats["acceptance_rate"]

    tok_s_spec = useful_tokens / (t_spec.min_us * 1e-6)
    tok_s_model = useful_tokens / (t_model.min_us * 1e-6)
    tok_s_base = useful_tokens / (t_base.min_us * 1e-6)

    # Table II energy per EMITTED token: an ngram round runs one W-wide verify
    # forward and emits 1 + acceptance * (W - 1) tokens; a model round also
    # pays W single-token draft forwards.
    e_draft = harness.lm_token_energy(cfg, qm.params)
    e_verify = harness.lm_token_energy(cfg, qm.verify_params)
    emitted = 1.0 + acc_rate * (spec_k - 1)
    ngram_nj = (spec_k * e_verify["compute_nj"] + e_verify["memory_nj"]) / emitted
    emitted_m = 1.0 + model_stats["acceptance_rate"] * (spec_k - 1)
    model_nj = (spec_k * (e_draft["compute_nj"] + e_verify["compute_nj"])
                + spec_k * e_draft["memory_nj"] + e_verify["memory_nj"]) / emitted_m

    return {
        "workload": "serve_speculative",
        "shape": {"arch": cfg.name, "draft": e_draft["fmt"], "verify": e_verify["fmt"],
                  "drafter": "ngram", "spec_k": spec_k, "n_slots": n_slots,
                  "n_requests": n_requests, "max_len": max_len, "useful_tokens": useful_tokens,
                  "train_steps": train_steps},
        "wall_us": {"speculative": t_spec.to_json(), "model_draft": t_model.to_json(),
                    "baseline": t_base.to_json()},
        "hlo": _hlo_keys(ngram_eng.decode_cost()),
        "quality": {
            "tokens_per_s_speculative": round(tok_s_spec, 1),
            "tokens_per_s_model_draft": round(tok_s_model, 1),
            "tokens_per_s_baseline": round(tok_s_base, 1),
            "speedup_vs_baseline": round(tok_s_spec / tok_s_base, 3),
            "speedup_model_draft": round(tok_s_model / tok_s_base, 3),
            "token_match_frac": round(matched / total, 4),
            "acceptance_rate": round(acc_rate, 4),
            "acceptance_rate_model_draft": round(model_stats["acceptance_rate"], 4),
            "tokens_drafted": ngram_stats["tokens_drafted"],
            "tokens_accepted": ngram_stats["tokens_accepted"],
            "energy_nj_per_token": round(ngram_nj, 2),
            "energy_nj_per_token_model_draft": round(model_nj, 2),
            "energy_nj_per_token_baseline": round(e_verify["total_nj"], 2),
        },
        "bytes": {"draft_bytes": packed_bytes(qm.params),
                  "verify_bytes": packed_bytes(qm.verify_params)},
    }


def _register_e2e_suite() -> None:
    variants = ("float", "packed", "packed_dynamic_act", "packed_calib")
    for tier, spec_name, batch in (("smoke", "alexnet_mini", 8), ("full", "vgg_mini", 64)):
        for variant in variants:
            register(WorkloadSpec(
                name=f"cnn_fwd/{spec_name}/{variant}/b{batch}", suite="e2e", tier=tier,
                run=functools.partial(_run_cnn_fwd, spec_name, batch, variant),
                tags=("cnn_fwd", spec_name, variant)))
    for tier, batch, prompt_len in (("smoke", 4, 32), ("full", 16, 128)):
        for quant in ("float", "elp4"):
            register(WorkloadSpec(
                name=f"lm_decode/qwen3_8b/{quant}/b{batch}s{prompt_len}", suite="e2e", tier=tier,
                run=functools.partial(_run_lm_decode, "qwen3_8b", quant, batch, prompt_len),
                tags=("lm_decode", quant)))
    # The continuous-batching engine against the static padded batch on a
    # mixed-length staggered trace.
    for tier, quant, n_slots, n_requests in (("smoke", "elp4", 4, 6), ("full", "elp4", 4, 12),
                                             ("full", "float", 4, 12)):
        register(WorkloadSpec(
            name=f"serve_continuous/serve_bench/{quant}/s{n_slots}r{n_requests}", suite="e2e",
            tier=tier,
            run=functools.partial(_run_serve_continuous, quant, n_slots, n_requests),
            tags=("serve_continuous", quant)))
    # Self-speculative serving: elp4 drafts, the float tier verifies.
    for tier, spec_k, n_slots, n_requests in (("smoke", 7, 4, 6), ("full", 7, 4, 12)):
        register(WorkloadSpec(
            name=f"serve_speculative/serve_bench/elp4_to_float/k{spec_k}s{n_slots}r{n_requests}",
            suite="e2e", tier=tier,
            run=functools.partial(_run_serve_speculative, spec_k, n_slots, n_requests),
            tags=("serve_speculative", "elp4")))


_register_kernel_suite()
_register_e2e_suite()


def autotune_shape_specs() -> list[tuple]:
    """``(m, k, n, fmt, nibble)`` of every registered matmul and im2col'd conv
    shape: what ``--autotune`` tunes (the reference's CPU grid cap has no
    counterpart, so every one)."""
    from repro_torch.bench.registry import specs

    return sorted({s.autotune_shape for s in specs("kernels") if s.autotune_shape is not None})
