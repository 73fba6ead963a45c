"""Process-local metrics: counters, gauges, log-bucket streaming histograms.

The port's copy of the JAX package's ``repro/obs/metrics.py``, with the
same names, bucket layout, percentile rule and exposition, so a snapshot
from either package reads the same. Three constraints shape it, all set by
where metrics are recorded (the serve engine's step loop):

  * **framework-free** — recording happens on the host between device
    dispatches; this module imports nothing but the standard library, so
    a record never touches the device.
  * **O(1) memory** — histograms keep fixed bucket COUNTS, never samples;
    percentiles are read from the buckets.
  * **off-by-default-cheap** — a disabled :class:`Registry` hands out
    shared null instruments whose ``inc``/``set``/``record`` are a single
    ``pass``.

Histogram buckets are log-spaced (``boundaries[i] = lo * growth**i``),
selected with ``bisect`` (upper-inclusive, Prometheus ``le`` semantics).
Quantiles return the bucket's upper boundary clamped to the exact
observed ``[min, max]``, which makes them exact for empty, single-sample
and all-equal streams.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "NULL_REGISTRY",
    "LATENCY_BUCKETS",
]

# Default latency bucket layout: 1 us .. ~69 s at quarter-octave
# (2**0.25 ~ 19%) resolution — 105 boundaries, ~one cache line of ints.
LATENCY_BUCKETS = (1e-6, 2.0**0.25, 105)


class Counter:
    """Monotonically increasing float total."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log-bucket streaming histogram with exact count/sum/min/max.

    ``counts`` has ``n_buckets + 1`` entries: ``counts[i]`` holds samples
    ``v <= boundaries[i]`` (and ``> boundaries[i-1]``); the final entry
    is the overflow bucket for ``v > boundaries[-1]``.  Values at or
    below ``lo`` land in bucket 0.
    """

    __slots__ = (
        "name",
        "lo",
        "growth",
        "n_buckets",
        "boundaries",
        "counts",
        "count",
        "total",
        "min",
        "max",
    )

    def __init__(
        self,
        name: str,
        lo: float = LATENCY_BUCKETS[0],
        growth: float = LATENCY_BUCKETS[1],
        n_buckets: int = LATENCY_BUCKETS[2],
    ):
        if lo <= 0 or growth <= 1.0 or n_buckets < 1:
            raise ValueError(
                "histogram needs lo > 0, growth > 1, n_buckets >= 1 "
                f"(got lo={lo}, growth={growth}, n_buckets={n_buckets})"
            )
        self.name = name
        self.lo = float(lo)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        # lo * growth**i with an integer exponent: reproducible across
        # calls, and EXACT where the inputs are exactly representable
        # (growth=2, lo=1 yields [1, 2, 4, 8, ...], not 7.999...),
        # which is what makes boundary-value bucketing deterministic
        self.boundaries = [lo * growth**i for i in range(n_buckets)]
        self.counts = [0] * (n_buckets + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.boundaries, v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float | None:
        """q-th percentile (``q`` in [0, 100]); ``None`` when empty.

        Returns the upper boundary of the bucket holding the rank-``q``
        sample, clamped to the observed ``[min, max]`` — so the answer
        is exact for empty/one-sample/all-equal streams and carries at
        most one ``growth`` factor of relative error otherwise.
        """
        if self.count == 0:
            return None
        rank = max(1, math.ceil(self.count * q / 100.0))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                ub = self.boundaries[i] if i < self.n_buckets else self.max
                return min(max(ub, self.min), self.max)
        return self.max  # unreachable: counts sum to self.count

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s buckets into this histogram (same layout only)."""
        if (self.lo, self.growth, self.n_buckets) != (other.lo, other.growth, other.n_buckets):
            raise ValueError(
                "cannot merge histograms with different bucket layouts: "
                f"{(self.lo, self.growth, self.n_buckets)} vs "
                f"{(other.lo, other.growth, other.n_buckets)}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def to_json(self) -> dict:
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": self.total,
            "min": None if empty else self.min,
            "max": None if empty else self.max,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "lo": self.lo,
            "growth": self.growth,
            "n_buckets": self.n_buckets,
            "counts": list(self.counts),
        }


class _NullCounter(Counter):
    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge(Gauge):
    def set(self, v: float) -> None:
        pass


class _NullHistogram(Histogram):
    def record(self, v: float) -> None:
        pass


class Registry:
    """Named instrument store; the unit the stack shares.

    One registry is threaded through a serving/training run; every
    subsystem asks it for instruments by dotted name (``serve.ttft_s``,
    ``train.step_s``, ...) and records into them.  ``enabled=False``
    (the default) returns shared null instruments — the whole
    observability layer then costs one attribute lookup plus one no-op
    call per event, measured in the ``serve_continuous`` bench entry.

    Creation is idempotent: asking for an existing name returns the
    existing instrument (histogram bucket-layout arguments must then
    match).  Asking for a name already registered as a different kind
    raises.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._null_counter = _NullCounter("null")
        self._null_gauge = _NullGauge("null")
        self._null_histogram = _NullHistogram("null")

    def _check_fresh(self, name: str, kind: dict) -> None:
        for other in (self._counters, self._gauges, self._histograms):
            if other is not kind and name in other:
                raise ValueError(f"metric {name!r} already registered as another kind")

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return self._null_counter
        with self._lock:
            if name not in self._counters:
                self._check_fresh(name, self._counters)
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return self._null_gauge
        with self._lock:
            if name not in self._gauges:
                self._check_fresh(name, self._gauges)
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(
        self,
        name: str,
        *,
        lo: float = LATENCY_BUCKETS[0],
        growth: float = LATENCY_BUCKETS[1],
        n_buckets: int = LATENCY_BUCKETS[2],
    ) -> Histogram:
        if not self.enabled:
            return self._null_histogram
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                self._check_fresh(name, self._histograms)
                h = self._histograms[name] = Histogram(
                    name, lo=lo, growth=growth, n_buckets=n_buckets
                )
            elif (h.lo, h.growth, h.n_buckets) != (lo, growth, n_buckets):
                raise ValueError(
                    f"histogram {name!r} exists with bucket layout "
                    f"{(h.lo, h.growth, h.n_buckets)}, requested "
                    f"{(lo, growth, n_buckets)}"
                )
            return h

    # -- introspection (export lives in repro_torch.obs.export) -------------------
    def counters(self) -> dict[str, Counter]:
        return dict(self._counters)

    def gauges(self) -> dict[str, Gauge]:
        return dict(self._gauges)

    def histograms(self) -> dict[str, Histogram]:
        return dict(self._histograms)


#: The shared disabled registry — what components fall back to when the
#: caller passes ``metrics=None``.  Never enable this instance; create a
#: ``Registry(enabled=True)`` instead.
NULL_REGISTRY = Registry(enabled=False)
