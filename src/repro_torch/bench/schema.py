"""Schema of the port's ``BENCH_*.json`` run documents, with a dependency-free validator.

The JAX package's ``repro/bench/schema.py``, field for field, with one
change: a port document names its PyTorch version (``torch_version``)
where the reference's names its JAX version. ``backend`` is the device
type the run measured, ``"cuda"`` or ``"cpu"``.

Document shape (version 1)::

    {
      "schema_version": 1,
      "suite": "kernels" | "e2e",
      "backend": "cuda" | "cpu",
      "torch_version": "2.11.0",
      "smoke_only": bool,            # was this run --smoke?
      "entries": {
        "<workload name>": {
          "workload": "<kind tag>",
          "tier": "smoke" | "full",
          "shape": {<str>: int | [int, ...] | str},
          "wall_us": {"<impl>": {"median_us": f, "min_us": f,
                                 "iters": i, "warmup": i} | null},
          "hlo":     {"flops": f|null, "bytes_accessed": f|null,
                      "collective_bytes": f} | null,
          "quality": {<str>: number} | null,
          "bytes":   {<str>: number} | null
        }, ...
      }
    }

Validation is hand-written, as in the reference, so no optional package
can make the gate skippable.
"""
from __future__ import annotations

from typing import Any

SCHEMA_VERSION = 1
SUITES = ("kernels", "e2e")
TIERS = ("smoke", "full")


class SchemaError(ValueError):
    """A BENCH document does not conform to the schema."""


def _expect(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise SchemaError(f"{path}: {msg}")


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_count(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 0


def _check_timing(t: Any, path: str) -> None:
    _expect(isinstance(t, dict), path, f"timing must be an object, got {type(t).__name__}")
    for key in ("median_us", "min_us"):
        _expect(_is_num(t.get(key)) and t[key] >= 0, f"{path}.{key}", "must be a number >= 0")
    for key in ("iters", "warmup"):
        _expect(_is_count(t.get(key)), f"{path}.{key}", "must be an int >= 0")


def _check_num_map(d: Any, path: str, *, allow_null_values: bool = False) -> None:
    _expect(isinstance(d, dict), path, f"must be an object, got {type(d).__name__}")
    for key, v in d.items():
        _expect(isinstance(key, str), path, f"non-string key {key!r}")
        if allow_null_values and v is None:
            continue
        _expect(_is_num(v), f"{path}.{key}", f"must be a number, got {type(v).__name__}")


def _check_entry(name: str, e: Any) -> None:
    path = f"entries[{name!r}]"
    _expect(isinstance(e, dict), path, "entry must be an object")
    _expect(isinstance(e.get("workload"), str) and e["workload"], f"{path}.workload",
            "must be a non-empty string")
    _expect(e.get("tier") in TIERS, f"{path}.tier", f"must be one of {TIERS}")

    shape = e.get("shape")
    _expect(isinstance(shape, dict) and shape, f"{path}.shape", "must be a non-empty object")
    for key, v in shape.items():
        ok = (
            (isinstance(v, int) and not isinstance(v, bool))
            or isinstance(v, str)
            or (isinstance(v, list) and all(isinstance(i, int) for i in v))
        )
        _expect(ok, f"{path}.shape.{key}", "must be int, str, or [int, ...]")

    wall = e.get("wall_us")
    _expect(isinstance(wall, dict) and wall, f"{path}.wall_us", "must map impl -> timing")
    for impl, t in wall.items():
        if t is not None:  # null: no counterpart, or not measured on this backend
            _check_timing(t, f"{path}.wall_us.{impl}")

    if e.get("hlo") is not None:
        hlo = e["hlo"]
        _check_num_map(hlo, f"{path}.hlo", allow_null_values=True)
        for key in ("flops", "bytes_accessed", "collective_bytes"):
            _expect(key in hlo, f"{path}.hlo", f"missing key {key!r}")
    if e.get("quality") is not None:
        _check_num_map(e["quality"], f"{path}.quality")
    if e.get("bytes") is not None:
        _check_num_map(e["bytes"], f"{path}.bytes")


def validate(doc: Any, *, suite: str | None = None) -> None:
    """Raise :class:`SchemaError` unless ``doc`` is a valid BENCH document."""
    _expect(isinstance(doc, dict), "$", "document must be an object")
    _expect(doc.get("schema_version") == SCHEMA_VERSION, "$.schema_version",
            f"must be {SCHEMA_VERSION}, got {doc.get('schema_version')!r}")
    _expect(doc.get("suite") in SUITES, "$.suite", f"must be one of {SUITES}")
    if suite is not None:
        _expect(doc["suite"] == suite, "$.suite", f"expected suite {suite!r}")
    _expect(isinstance(doc.get("backend"), str) and doc["backend"], "$.backend",
            "must be a non-empty string")
    _expect(isinstance(doc.get("torch_version"), str) and doc["torch_version"],
            "$.torch_version", "must be a non-empty string")
    _expect(isinstance(doc.get("smoke_only"), bool), "$.smoke_only", "must be a bool")
    entries = doc.get("entries")
    _expect(isinstance(entries, dict) and entries, "$.entries", "must be a non-empty object")
    for name, e in entries.items():
        _check_entry(name, e)
