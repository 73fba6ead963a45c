"""Metric exposition: Prometheus text format + schema-versioned snapshots.

The port's copy of the JAX package's ``repro/obs/export.py``: the same
text and the same snapshot document, so either package's validator reads
the other's snapshots.

Two export shapes, one registry:

  * :func:`prometheus_text` — the de-facto scrape format.  Counters and
    gauges are single samples; histograms expose cumulative
    ``_bucket{le="..."}`` series (the bucket layout is upper-inclusive,
    which is exactly Prometheus ``le`` semantics), ``_sum`` and
    ``_count``.  Dotted metric names are sanitized to the
    ``[a-zA-Z_][a-zA-Z0-9_]*`` charset.
  * :func:`snapshot` / :func:`validate_snapshot` — a schema-versioned
    JSON document for committing, diffing, and gating (same hand-rolled
    validator style as the JAX package's ``repro.bench.schema``, and for
    the same reason: the validation must never be skippable because an optional
    jsonschema package is absent).

Snapshot shape (version 1)::

    {
      "schema_version": 1,
      "kind": "obs_snapshot",
      "counters":  {"<name>": number, ...},
      "gauges":    {"<name>": number, ...},
      "histograms": {
        "<name>": {
          "count": int, "sum": number,
          "min": number|null, "max": number|null, "mean": number|null,
          "p50": number|null, "p90": number|null, "p99": number|null,
          "lo": number, "growth": number, "n_buckets": int,
          "counts": [int, ...]        # n_buckets + 1 (overflow last)
        }, ...
      }
    }
"""
from __future__ import annotations

import json
import re
from typing import Any

from repro_torch.obs.metrics import Registry

__all__ = [
    "SNAPSHOT_VERSION",
    "SnapshotError",
    "prometheus_text",
    "snapshot",
    "validate_snapshot",
    "write_snapshot",
    "load_snapshot",
]

SNAPSHOT_VERSION = 1
SNAPSHOT_KIND = "obs_snapshot"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


class SnapshotError(ValueError):
    """An obs snapshot document does not conform to the schema."""


def _prom_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    return out if out[:1].isalpha() or out[:1] == "_" else "_" + out


def prometheus_text(reg: Registry) -> str:
    """Text exposition of every instrument in ``reg``."""
    lines: list[str] = []
    for name, c in sorted(reg.counters().items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {c.value:g}")
    for name, g in sorted(reg.gauges().items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {g.value:g}")
    for name, h in sorted(reg.histograms().items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for i, ub in enumerate(h.boundaries):
            cum += h.counts[i]
            lines.append(f'{pn}_bucket{{le="{ub:g}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{pn}_sum {h.total:g}")
        lines.append(f"{pn}_count {h.count}")
    return "\n".join(lines) + "\n"


def snapshot(reg: Registry) -> dict:
    """Schema-versioned JSON-ready snapshot of every instrument."""
    return {
        "schema_version": SNAPSHOT_VERSION,
        "kind": SNAPSHOT_KIND,
        "counters": {n: c.value for n, c in sorted(reg.counters().items())},
        "gauges": {n: g.value for n, g in sorted(reg.gauges().items())},
        "histograms": {n: h.to_json() for n, h in sorted(reg.histograms().items())},
    }


def write_snapshot(reg: Registry, path: str) -> dict:
    doc = snapshot(reg)
    validate_snapshot(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    validate_snapshot(doc)
    return doc


# ---------------------------------------------------------------------------
# Validator (hand-rolled, dependency-free — see module docstring)
# ---------------------------------------------------------------------------
def _fail(path: str, msg: str) -> None:
    raise SnapshotError(f"{path}: {msg}")


def _expect(cond: bool, path: str, msg: str) -> None:
    if not cond:
        _fail(path, msg)


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _check_num_map(d: Any, path: str) -> None:
    _expect(isinstance(d, dict), path, f"must be an object, got {type(d).__name__}")
    for key, v in d.items():
        _expect(isinstance(key, str) and key, path, f"non-string key {key!r}")
        _expect(_is_num(v), f"{path}.{key}", f"must be a number, got {type(v).__name__}")


def _check_histogram(name: str, h: Any) -> None:
    path = f"histograms[{name!r}]"
    _expect(isinstance(h, dict), path, "must be an object")
    _expect(_is_int(h.get("count")) and h["count"] >= 0, f"{path}.count", "must be an int >= 0")
    _expect(_is_num(h.get("sum")), f"{path}.sum", "must be a number")
    for key in ("min", "max", "mean", "p50", "p90", "p99"):
        v = h.get(key, "MISSING")
        if h["count"] == 0:
            _expect(v is None, f"{path}.{key}", "must be null for an empty histogram")
        else:
            _expect(_is_num(v), f"{path}.{key}", "must be a number")
    _expect(_is_num(h.get("lo")) and h["lo"] > 0, f"{path}.lo", "must be a number > 0")
    _expect(_is_num(h.get("growth")) and h["growth"] > 1, f"{path}.growth", "must be > 1")
    _expect(
        _is_int(h.get("n_buckets")) and h["n_buckets"] >= 1,
        f"{path}.n_buckets",
        "must be an int >= 1",
    )
    counts = h.get("counts")
    _expect(isinstance(counts, list), f"{path}.counts", "must be a list")
    _expect(
        len(counts) == h["n_buckets"] + 1,
        f"{path}.counts",
        f"must have n_buckets + 1 = {h['n_buckets'] + 1} entries, got {len(counts)}",
    )
    _expect(
        all(_is_int(c) and c >= 0 for c in counts), f"{path}.counts", "entries must be ints >= 0"
    )
    _expect(
        sum(counts) == h["count"],
        f"{path}.counts",
        f"must sum to count ({h['count']}), got {sum(counts)}",
    )


def validate_snapshot(doc: Any) -> None:
    """Raise :class:`SnapshotError` unless ``doc`` is a valid snapshot."""
    _expect(isinstance(doc, dict), "$", "document must be an object")
    _expect(
        doc.get("schema_version") == SNAPSHOT_VERSION,
        "$.schema_version",
        f"must be {SNAPSHOT_VERSION}, got {doc.get('schema_version')!r}",
    )
    _expect(
        doc.get("kind") == SNAPSHOT_KIND,
        "$.kind",
        f"must be {SNAPSHOT_KIND!r}, got {doc.get('kind')!r}",
    )
    for key in ("counters", "gauges", "histograms"):
        _expect(key in doc, "$", f"missing key {key!r}")
    _check_num_map(doc["counters"], "$.counters")
    _check_num_map(doc["gauges"], "$.gauges")
    _expect(isinstance(doc["histograms"], dict), "$.histograms", "must be an object")
    for name, h in doc["histograms"].items():
        _expect(isinstance(name, str) and name, "$.histograms", f"non-string key {name!r}")
        _check_histogram(name, h)
