"""Observability: metrics, per-request tracing, exposition.

The port's copy of the JAX package's ``repro/obs``:

  * :class:`~repro_torch.obs.metrics.Registry` — process-local store of
    counters, gauges and log-bucket streaming histograms (standard
    library only, O(1) memory; a disabled registry is a no-op).
  * :class:`~repro_torch.obs.trace.TraceLog` — per-request span events
    (submit -> admit -> decode/round -> finish) to a JSONL sink.
  * :class:`~repro_torch.obs.trace.ProfileHook` — a ``torch.profiler``
    capture around the first N decode dispatches.
  * :func:`~repro_torch.obs.export.prometheus_text` /
    :func:`~repro_torch.obs.export.snapshot` /
    :func:`~repro_torch.obs.export.validate_snapshot` — Prometheus text
    exposition and the schema-versioned JSON snapshot.

Consumers: :class:`repro_torch.serve.engine.ServeEngine` (TTFT/ITL
histograms, speculative round stats, modeled energy per token) and
:class:`repro_torch.runtime.straggler.StragglerMonitor` (built on the
histogram).
"""
from repro_torch.obs.export import (
    SnapshotError,
    load_snapshot,
    prometheus_text,
    snapshot,
    validate_snapshot,
    write_snapshot,
)
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS,
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from repro_torch.obs.trace import ProfileHook, TraceLog

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "NULL_REGISTRY",
    "ProfileHook",
    "Registry",
    "SnapshotError",
    "TraceLog",
    "load_snapshot",
    "prometheus_text",
    "snapshot",
    "validate_snapshot",
    "write_snapshot",
]
