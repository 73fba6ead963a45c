"""Serve a small LM with continuous batching and ELP_BSD-encoded weights.

The JAX package's ``examples/serve_quantized.py`` on the port. It trains
briefly, converts every matmul weight through the ``repro_torch.api`` front
door (the paper's Sec. V methodology with per-row compensation), then serves
through two paths and cross-checks them:

  1. ``QuantizedModel.generate``: a batch of same-length prompts, compared
     against the unquantized model (token agreement and weight bytes),
     also after a save/load round-trip of the artifact;
  2. ``QuantizedModel.serve``: the continuous-batching engine on a trace of
     mixed-length requests, each of whose outputs must be token-identical
     to its own per-request static generation.

``--speculative`` serves the self-speculative draft/verify engine instead:
the artifact is built with ``QuantScheme.speculative`` (an elp4 draft tier
and a float verify tier), and both drafters (the elp4 model drafter and the
token-recycling ngram table) serve the same trace. Every request must stay
token-identical to its own static generation on the verify tier.

Any drift is a hard failure: the script exits nonzero.

``--metrics-out PATH`` records the whole run (train-step times and the
serve legs' TTFT, ITL and energy) into one obs registry and writes its
schema-versioned snapshot to PATH, which
``python -m repro_torch.obs --validate PATH`` checks.

Under ``torchrun`` (``WORLD_SIZE`` above 1) every rank runs the script: each
trains the same model, and the engine lays an elastic mesh over the ranks
(``gloo`` on the CPU) and serves the packed tree sharded, every rank with the
same requests and the same tokens.

    python -m repro_torch.experiments.serve_quantized [--speculative] [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.experiments.serve_quantized --device cpu

``SERVE_DEMO_STEPS`` sets the training steps (default 150; fewer for a smoke run).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import LmDataset
from repro_torch.launch.mesh import world_mesh
from repro_torch.obs import Registry, write_snapshot
from repro_torch.runtime.train_loop import TrainSetup, train
from repro_torch.serve.engine import ServeSetup, static_generate

CFG = ArchConfig(
    name="serve-demo",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    head_dim=64,
    dtype_str="float32",
)


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _trace(device) -> tuple[dict, list]:
    """The prompts ``[4, 32]`` and the mixed-length request trace."""
    ds = LmDataset(CFG, seq_len=32, batch=4, seed=9)
    base = ds.np_batch(0)["tokens"]
    reqs = [(base[0, :8], 12), (base[1, :16], 10), (base[2, :32], 8), (base[3, :8], 6)]
    return {"tokens": torch.from_numpy(np.asarray(base)).to(device)}, reqs


def _static(params, prompt, n: int, device) -> np.ndarray:
    """One request's own greedy static generation, without a mesh."""
    s1 = ServeSetup(cfg=CFG, mesh=None, max_len=len(prompt) + n, batch=1)
    tokens = torch.from_numpy(np.asarray(prompt)[None]).to(device)
    return static_generate(s1, params, {"tokens": tokens}, n)[0].cpu().numpy()


def speculative_main(params, device, metrics=None) -> None:
    """--speculative: draft/verify serving, hard-failing on any drift."""
    _, reqs = _trace(device)
    refs = [_static(params, prompt, n, device) for prompt, n in reqs]
    for drafter in ("model", "ngram"):
        scheme = api.QuantScheme.speculative(draft="elp4", K=5, drafter=drafter)
        qm = api.quantize(CFG, params, scheme, device=device)
        print(f"speculative serving ({drafter} drafter, K={scheme.spec_k}) on {_ranks()} "
              "rank(s) ...")
        outs = qm.serve(reqs, n_slots=2, max_len=64, metrics=metrics)
        ok = True
        for i, (got, want) in enumerate(zip(outs, refs)):
            match = bool(np.array_equal(np.asarray(got), want))
            ok &= match
            print(f"  req {i}: +{len(want)} tokens -> {np.asarray(got)[:8]} (identity: {match})")
        if not ok:
            raise SystemExit(f"speculative serving ({drafter} drafter) is NOT token-identical "
                             "to static generation on the verify tier")
    print("speculative serving token-identical for both drafters")


def serve_main(params, device, metrics=None) -> None:
    """Generate and serve the elp4 artifact, hard-failing on any drift."""
    print("converting matmul weights to packed ELP_BSD (4b) via repro_torch.api ...")
    qm = api.quantize(CFG, params, api.QuantScheme(fmt="elp4"), device=device)
    r = qm.report
    print(f"  weight bytes: {r.raw_bytes} -> {r.packed_bytes} ({r.compression:.2f}x)")

    prompts, reqs = _trace(device)
    setup = ServeSetup(cfg=CFG, mesh=None, max_len=64, batch=4)
    ref = static_generate(setup, params, prompts, max_new_tokens=16)
    quant = qm.generate(prompts, max_new_tokens=16)
    agree = float(torch.mean((ref.cpu() == quant.cpu()).to(torch.float32)))
    print(f"  greedy tokens, fp32 vs ELP_BSD-4b: {agree * 100:.0f}% agreement")
    print("  fp32 :", ref[0].cpu().numpy()[:12])
    print("  elp4 :", quant[0].cpu().numpy()[:12])

    print("save/load round-trip of the quantized artifact ...")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_demo_elp4")
        qm.save(path)  # every rank into a directory of its own
        quant2 = api.load(path, device=device).generate(prompts, max_new_tokens=16)
        same = bool(torch.equal(quant, quant2))
        print(f"  reloaded generate bit-identical: {same}")
        if not same:
            raise SystemExit("save/load round-trip drifted — artifact path broken")

    print(f"continuous-batching engine on {_ranks()} rank(s) ...")
    outs = qm.serve(reqs, n_slots=2, max_len=64, metrics=metrics)
    ok = True
    for i, ((prompt, n), got) in enumerate(zip(reqs, outs)):
        want = _static(qm.params, prompt, n, device)
        match = bool(np.array_equal(got, want))
        ok &= match
        print(f"  req {i}: prompt[{len(prompt)}] +{n} tokens -> {got[:8]} (parity: {match})")
    if not ok:
        raise SystemExit("continuous-batching output drifted from per-request static generation")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--speculative", action="store_true",
                    help="serve draft/verify rounds (both drafters) and hard-fail on drift")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's obs snapshot (train + serve telemetry) to PATH")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _, device = world_mesh(device=args.device)  # starts the group under torchrun
    metrics = Registry(enabled=True) if args.metrics_out else None
    steps = int(os.environ.get("SERVE_DEMO_STEPS", "150"))
    print(f"training a small LM on the synthetic stream ({steps} steps) on {device} ...")
    out = train(TrainSetup(cfg=CFG, mesh=None, lr_peak=3e-3, warmup=20, total_steps=steps,
                           remat=False),
                steps=steps, batch_size=16, seq_len=64, log_every=50, metrics=metrics,
                device=device)
    params = out["params"]
    if args.speculative:
        speculative_main(params, device, metrics=metrics)
    else:
        serve_main(params, device, metrics=metrics)
    if args.metrics_out and (not dist.is_initialized() or dist.get_rank() == 0):
        write_snapshot(metrics, args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")


if __name__ == "__main__":
    main()
