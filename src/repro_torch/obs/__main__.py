"""``python -m repro_torch.obs`` — validate / inspect exported obs snapshots.

  --validate FILE [FILE...]   schema-check snapshot JSON files (exit 1
                              on the first violation) — the CI entry
  --prom FILE                 print a snapshot back as Prometheus text
                              (rebuilds a registry from the document)
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs import export
from repro_torch.obs.metrics import Registry


def _registry_from(doc: dict) -> Registry:
    reg = Registry(enabled=True)
    for name, v in doc["counters"].items():
        reg.counter(name).inc(v)
    for name, v in doc["gauges"].items():
        reg.gauge(name).set(v)
    for name, h in doc["histograms"].items():
        hist = reg.histogram(name, lo=h["lo"], growth=h["growth"], n_buckets=h["n_buckets"])
        hist.counts = list(h["counts"])
        hist.count = h["count"]
        hist.total = h["sum"]
        if h["count"]:
            hist.min, hist.max = h["min"], h["max"]
    return reg


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("--validate", nargs="+", default=None, metavar="FILE")
    ap.add_argument("--prom", default=None, metavar="FILE")
    args = ap.parse_args(argv)

    if args.validate:
        for path in args.validate:
            try:
                doc = export.load_snapshot(path)
            except export.SnapshotError as e:
                print(f"[obs] INVALID {path}: {e}", file=sys.stderr)
                return 1
            print(
                f"[obs] ok: {path} ({len(doc['counters'])} counters, "
                f"{len(doc['gauges'])} gauges, {len(doc['histograms'])} histograms)"
            )
        return 0

    if args.prom:
        print(export.prometheus_text(_registry_from(export.load_snapshot(args.prom))), end="")
        return 0

    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
