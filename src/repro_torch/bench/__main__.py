"""``python -m repro_torch.bench``: run, validate and gate the benchmark suites.

The JAX package's ``python -m repro.bench`` on the port. Modes:

  run (default)      execute registered workloads, write BENCH_*.json
    --smoke          smoke tier only
    --suite S        kernels | e2e | all (default all)
    --only SUBSTR    filter workloads by name substring
    --out-dir DIR    where BENCH_*.json land (default: build/bench/)
    --iters/--warmup harness budget per measurement
    --autotune       time the kernels at every registered shape first
                     and write the autotune cache
    --device D       cuda (default) or cpu

  --list             print registered workload names and exit
  --validate F [F..] schema-check existing BENCH json files and exit
  --gate-against DIR compare this run's times with the documents in DIR;
                     fail (exit 1) on a regression beyond --tolerance
                     (default 0.20) after normalising for machine drift

The default output directory is ``build/bench/``, never the repository's
root, where the JAX package's committed ``BENCH_*.json`` lie.

Gate semantics, the reference's: hosts differ in absolute speed and single
timings are noisy, so the gate neither compares raw times nor gates single
entries at the tolerance. It

  a. compares ``min_us``;
  b. skips ``tiled`` timings when the baseline ran on the CPU, where both
     kernels are the same plain version (the reference skips its
     interpret-mode ``pallas`` timings there);
  c. aggregates entry ratios into per-workload-kind groups by geometric mean;
  d. normalises each group by the leave-one-group-out geomean over the OTHER
     groups' entries, pooled across suites (uniform drift cancels, but a
     group cannot hide its own regression inside the drift estimate); and
  e. fails when a group's normalised geomean exceeds
     ``1 + tolerance * (1 + 2/sqrt(n))``, or any single entry exceeds
     ``1 + 4*tolerance`` (the catastrophic check).

Entries faster than ``--min-us`` in the baseline are skipped as timer noise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.bench import registry, schema
from repro_torch.bench.autotune import autotune_shapes, invalidate_memory_cache
from repro_torch.device import resolve_device

REPO_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
OUT_DIR = os.path.join(REPO_ROOT, "build", "bench")


def bench_filename(suite: str) -> str:
    return f"BENCH_{suite}.json"


def run_suite(suite: str, *, smoke_only: bool, only: str | None, iters: int, warmup: int,
              device=None) -> dict:
    device = resolve_device(device)
    entries = {}
    for spec in registry.specs(suite, smoke_only=smoke_only, only=only):
        print(f"[bench] {suite}: {spec.name}", file=sys.stderr)
        body = spec.run(iters, warmup, device)
        body["tier"] = spec.tier
        entries[spec.name] = body
    return {
        "schema_version": schema.SCHEMA_VERSION,
        "suite": suite,
        "backend": device.type,
        "torch_version": torch.__version__,
        "smoke_only": smoke_only,
        "entries": entries,
    }


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _collect_ratios(new_doc: dict, base: dict, min_us: float) -> list[tuple]:
    """``(group, name, impl, base_us, new_us, ratio, entry_gate)`` per comparable timing.

    ``entry_gate`` marks timings eligible for the single-entry catastrophic
    check. A ``selected`` timing whose auto dispatch took the SAME impl as
    the baseline run is exempt: its time duplicates that impl's own (gated)
    key. It still votes in the group geomean, and when the dispatch FLIPPED
    impls between runs the full check applies.
    """
    skip_tiled = base.get("backend") == "cpu"
    out = []
    for name, new_e in new_doc["entries"].items():
        base_e = base["entries"].get(name)
        if base_e is None:
            continue
        for impl, new_t in new_e["wall_us"].items():
            base_t = base_e["wall_us"].get(impl)
            if not new_t or not base_t or base_t["min_us"] < min_us:
                continue
            if impl == "tiled" and skip_tiled:
                continue  # the CPU's plain version: trend data, not a signal
            entry_gate = True
            if impl == "selected" and new_t.get("impl") == base_t.get("impl"):
                entry_gate = False
            if impl == "selected" and new_t.get("impl") == "tiled" and skip_tiled:
                continue
            out.append((new_e["workload"], name, impl, base_t["min_us"], new_t["min_us"],
                        new_t["min_us"] / base_t["min_us"], entry_gate))
    return out


def _geomean(xs) -> float:
    return float(np.exp(np.mean(np.log(xs))))


def _gate(ratios: list[tuple], tolerance: float) -> list[str]:
    """Failure messages for time regressions (see the module docstring)."""
    if not ratios:
        return ["no comparable entries between this run and the baselines"]
    groups: dict[str, list[float]] = {}
    for group, _name, _impl, _base, _new, ratio, _eg in ratios:
        groups.setdefault(group, []).append(ratio)
    # Drift per group is estimated leave-one-group-out, so a group's own
    # regression does not inflate the drift it is normalised by. A run of one
    # group (--only) has no outside reference and gates on raw ratios.
    pooled = _geomean([r[5] for r in ratios])
    drift_logo = {
        g: _geomean([r[5] for r in ratios if r[0] != g]) if len(groups) > 1 else 1.0
        for g in groups
    }
    print(f"[gate] pooled drift x{pooled:.2f} over {len(ratios)} timings; per-group LOGO drift "
          f"{{{', '.join(f'{g}: x{d:.2f}' for g, d in sorted(drift_logo.items()))}}}",
          file=sys.stderr)

    failures = []
    for group, name, impl, base_us, new_us, ratio, entry_gate in ratios:
        normalized = ratio / drift_logo[group]
        line = (f"{name} [{impl}]: {base_us:.0f}us -> {new_us:.0f}us "
                f"(x{ratio:.2f} raw, x{normalized:.2f} drift-normalized)")
        if entry_gate and normalized > 1.0 + 4.0 * tolerance:
            failures.append(f"REGRESSION (entry, >x{1 + 4 * tolerance:.1f}) " + line)
        else:
            print("[gate] ok " + line, file=sys.stderr)

    for group, rs in sorted(groups.items()):
        g_norm = _geomean(rs) / drift_logo[group]
        # The geomean of n noisy timings spreads about 1/sqrt(n) as much as
        # one: small groups get a proportionally wider threshold.
        tol_eff = tolerance * (1.0 + 2.0 / len(rs) ** 0.5)
        line = (f"group {group}: x{g_norm:.2f} drift-normalized geomean over {len(rs)} timings "
                f"(threshold x{1 + tol_eff:.2f})")
        if g_norm > 1.0 + tol_eff:
            failures.append("REGRESSION (group) " + line)
        else:
            print("[gate] ok " + line, file=sys.stderr)
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    ap.add_argument("--smoke", action="store_true", help="smoke tier only")
    ap.add_argument("--suite", default="all", choices=["kernels", "e2e", "all"])
    ap.add_argument("--only", default=None, help="substring filter on workload names")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--validate", nargs="+", default=None, metavar="FILE")
    ap.add_argument("--gate-against", default=None, metavar="DIR")
    ap.add_argument("--tolerance", type=float, default=0.20)
    ap.add_argument("--min-us", type=float, default=200.0)
    ap.add_argument("--autotune", action="store_true")
    args = ap.parse_args(argv)

    suites = list(schema.SUITES) if args.suite == "all" else [args.suite]

    if args.list:
        for suite in suites:
            for spec in registry.specs(suite, smoke_only=args.smoke, only=args.only):
                print(f"{suite:8s} {spec.tier:6s} {spec.name}")
        return 0

    if args.validate:
        for path in args.validate:
            doc = _load(path)
            schema.validate(doc)
            print(f"[schema] ok: {path} ({len(doc['entries'])} entries, suite={doc['suite']})")
        return 0

    device = resolve_device(args.device)
    iters = args.iters if args.iters is not None else 5
    warmup = args.warmup if args.warmup is not None else (1 if args.smoke else 2)

    if args.autotune:
        from repro_torch.bench.workloads import autotune_shape_specs

        shapes = autotune_shape_specs()
        print(f"[autotune] tuning {len(shapes)} shapes", file=sys.stderr)
        for res in autotune_shapes(shapes, device=device):
            print(f"[autotune] {res['key']} -> {res['impl']} ({res['wall_us']:.1f}us; "
                  + ", ".join(f"{r['impl']} {r['wall_us']:.1f}" for r in res["ranking"]) + ")",
                  file=sys.stderr)
        invalidate_memory_cache()

    failures: list[str] = []
    ratios: list[tuple] = []
    for suite in suites:
        doc = run_suite(suite, smoke_only=args.smoke, only=args.only, iters=iters,
                        warmup=warmup, device=device)
        if not doc["entries"]:
            print(f"[bench] {suite}: no workloads selected, skipping", file=sys.stderr)
            continue
        schema.validate(doc, suite=suite)
        out_path = os.path.join(args.out_dir, bench_filename(suite))
        os.makedirs(args.out_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[bench] wrote {out_path} ({len(doc['entries'])} entries)")
        if args.gate_against:
            base_path = os.path.join(args.gate_against, bench_filename(suite))
            if not os.path.exists(base_path):
                failures.append(f"baseline {base_path} missing")
                continue
            base = _load(base_path)
            schema.validate(base, suite=suite)
            ratios += _collect_ratios(doc, base, args.min_us)

    # Drift normalisation pools every suite's ratios.
    if args.gate_against and not failures:
        failures += _gate(ratios, args.tolerance)

    if failures:
        for msg in failures:
            print("[gate] " + msg, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
