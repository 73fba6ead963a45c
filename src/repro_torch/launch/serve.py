"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The JAX package's ``repro/launch/serve.py``. Drives the continuous-batching
engine (:mod:`repro_torch.serve.engine`) on seeded weights, optionally
converted to packed ELP_BSD through the ``repro_torch.api`` front door,
with a mixed-length staggered request trace (no padding of short prompts,
slots reused the step a request finishes). Prints each request's output,
throughput, the latency report (p50/p99 TTFT, inter-token latency, request
time from the engine's obs histograms), the Table II modeled energy a
token and the straggler monitor's slow-step summary. ``--flash-decode``
asks for the sequence-sharded flash-decoding cache layout, which takes
effect under a mesh; one process serves without a mesh, as the JAX
launcher does with one device. Under ``torchrun`` with more than one rank
the mesh spans them (the model axis' target 16, halved until it divides
the rank count), and the engine serves over it, SPMD: every rank makes the
same trace and the same calls, holds its slots' rows and its blocks of the
parameters, and prints the same tokens. ``--static`` (and a family outside
the engine) serves the lockstep loop over it the same way.

``--metrics-out PATH`` also writes the schema-versioned obs snapshot to
PATH and the per-request span events to its sibling ``*.events.jsonl``
(``python -m repro_torch.obs --validate PATH``). Families outside the
engine (recurrent, enc-dec and frontend models) and ``--static`` run the
lockstep ``static_generate``. ``--device cpu`` runs on the host (default:
the card).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import LmDataset
from repro_torch.launch.mesh import world_mesh
from repro_torch.models import get_model
from repro_torch.runtime.quantized_params import packed_bytes
from repro_torch.serve.engine import ENGINE_FAMILIES, ServeEngine, ServeSetup, static_generate


def _trace(ds: LmDataset, prompt_len: int, n_requests: int, max_new: int):
    """Deterministic mixed-length request trace with staggered arrivals."""
    base = np.asarray(ds.np_batch(0)["tokens"])
    lens = (max(prompt_len // 4, 4), max(prompt_len // 2, 8), prompt_len)
    news = (max_new, max(max_new // 2, 4), max(max_new // 4, 2))
    reqs, arrivals = [], []
    for i in range(n_requests):
        row = base[i % base.shape[0]]
        reqs.append((row[: lens[i % 3]], news[i % 3]))
        arrivals.append(i // 2)  # two arrivals per engine step
    return reqs, arrivals


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant", default=None, choices=[None, "elp4", "elp8"])
    ap.add_argument("--flash-decode", action="store_true")
    ap.add_argument("--static", action="store_true", help="the lockstep batch loop")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative draft/verify serving: the --draft-fmt tier (or the "
                         "ngram table) drafts, the served weights verify and define the output")
    ap.add_argument("--spec-k", type=int, default=7, help="speculative verify width (>= 2)")
    ap.add_argument("--draft-fmt", default="elp4", choices=["elp4", "elp8", "ngram"],
                    help='draft source for --speculative: a packed tier of the same '
                         'checkpoint, or "ngram" (token-recycling lookup, no draft forwards)')
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the obs snapshot JSON here (and the span event log to the "
                         "sibling *.events.jsonl)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the first decode dispatches into DIR")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh, device = world_mesh(device=args.device)
    from repro_torch import api as front

    params = get_model(cfg).init_params(cfg, 0, device=device)
    draft_params = None
    spec_draft = "model"
    if args.speculative and args.draft_fmt != "ngram":
        draft_params = front.quantize(cfg, params, front.QuantScheme(fmt=args.draft_fmt),
                                      device=device).params
        print(f"speculative serving: {args.draft_fmt} drafts "
              f"({packed_bytes(draft_params) / 1e6:.1f} MB), "
              f"{'packed' if args.quant else 'float'} verifies, K={args.spec_k}")
    elif args.speculative:
        spec_draft = "ngram"
        print(f"speculative serving: ngram drafts, K={args.spec_k}")
    if args.quant:
        params = front.quantize(cfg, params, front.QuantScheme(fmt=args.quant),
                                device=device).params
        print(f"quantized weights: {packed_bytes(params) / 1e6:.1f} MB")

    ds = LmDataset(cfg, seq_len=args.prompt_len, batch=max(args.slots, 4), seed=7)
    max_len = args.prompt_len + args.max_new
    static = args.static or cfg.family not in ENGINE_FAMILIES or cfg.frontend_tokens
    if args.speculative and static:
        raise SystemExit("--speculative needs the slot engine (transformer families, not "
                         "--static): the lockstep loop has no draft/verify path")
    if static:
        npb = ds.np_batch(0)
        batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in npb.items()
                 if k != "labels"}
        setup = ServeSetup(cfg=cfg, mesh=mesh, max_len=max_len, batch=batch["tokens"].shape[0],
                           flash_decode=args.flash_decode)
        toks = static_generate(setup, params, batch, max_new_tokens=args.max_new)
        print("generated (static batch):", toks.cpu().numpy()[:, :12])
        return {"tokens": toks}

    from repro_torch.obs import ProfileHook, Registry, TraceLog, write_snapshot

    registry = Registry(enabled=True)
    trace_log = None
    if args.metrics_out:
        trace_log = TraceLog(sink=os.path.splitext(args.metrics_out)[0] + ".events.jsonl")
    profile = ProfileHook(args.profile_dir) if args.profile_dir else None
    engine = ServeEngine(cfg, params, n_slots=args.slots, max_len=max_len, mesh=mesh,
                         flash_decode=args.flash_decode, draft_params=draft_params,
                         spec_k=args.spec_k if args.speculative else 0, spec_draft=spec_draft,
                         metrics=registry, trace=trace_log, profile=profile)
    reqs, arrivals = _trace(ds, args.prompt_len, args.requests, args.max_new)
    t0 = time.perf_counter()
    outs = engine.serve(reqs, arrivals=arrivals)
    dt = time.perf_counter() - t0

    for i, ((prompt, _), out) in enumerate(zip(reqs, outs)):
        print(f"req {i}: prompt[{len(prompt)}] -> {out[:12]}")
    st = engine.stats()
    print(f"served {len(reqs)} requests / {st['tokens_generated']} tokens in {dt:.2f}s "
          f"({st['tokens_generated'] / dt:.1f} tok/s; {st['decode_steps']} decode steps, "
          f"{st['prefills']} prefills, mesh={st['mesh']})")
    if "speculative" in st:
        sp = st["speculative"]
        print(f"speculative: {sp['drafter']} drafter, K={sp['spec_k']}, {sp['rounds']} rounds, "
              f"{sp['tokens_accepted']}/{sp['tokens_drafted']} drafted tokens accepted "
              f"({sp['acceptance_rate']:.3f})")
    lat = st["latency"]
    print(f"latency: TTFT p50 {lat['ttft_p50_s'] * 1e3:.1f} ms / "
          f"p99 {lat['ttft_p99_s'] * 1e3:.1f} ms; ITL p50 {lat['itl_p50_s'] * 1e3:.2f} ms / "
          f"p99 {lat['itl_p99_s'] * 1e3:.2f} ms; request p50 "
          f"{lat['request_p50_s'] * 1e3:.1f} ms / p99 {lat['request_p99_s'] * 1e3:.1f} ms")
    e = engine.energy
    print(f"energy (Table II model): {e['total_nj']:.0f} nJ/token ({e['fmt']}, "
          f"{e['macs_per_token'] / 1e6:.1f} M MACs: compute {e['compute_nj']:.0f} nJ + weight "
          f"stream {e['memory_nj']:.0f} nJ); total "
          f"{registry.counter('serve.energy_nj_total').value / 1e6:.2f} mJ")
    sr = st["straggler"]
    print(f"straggler: {sr['straggle_events']} slow steps over {sr['steps']} (step p50 "
          f"{sr['p50_s'] * 1e3:.1f} ms / p99 {sr['p99_s'] * 1e3:.1f} ms, worst "
          f"x{sr['worst_ratio']:.2f})")
    if trace_log is not None:
        trace_log.close()
    if args.metrics_out:
        write_snapshot(registry, args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    return {"outputs": outs, "stats": st}


if __name__ == "__main__":
    main()
