"""Straggler detection: slow steps against a rolling median.

The port's copy of the JAX package's ``repro/runtime/straggler.py``. The
monitor keeps a rolling step-time median; a step slower than
``threshold x median`` is a straggle event, handed to an optional
``on_straggle`` callback and counted. The serve engine records each
decode step's (or speculative round's) wall clock here.

Memory is O(1) in the number of steps: the rolling median reads a
``deque`` capped at ``window`` entries, the whole step-time distribution
lives in a :class:`repro_torch.obs.metrics.Histogram`, and the event list
keeps only the ``window`` most recent events plus running totals.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import deque
from typing import Callable

from repro_torch.obs.metrics import Histogram


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    window: int = 50
    on_straggle: Callable[[int, float, float], None] | None = None

    def __post_init__(self) -> None:
        self._times: deque[float] = deque(maxlen=self.window)
        self._events: deque[tuple[int, float, float]] = deque(maxlen=self.window)
        self.hist = Histogram("straggler.step_s")
        self._n_events = 0
        self._worst_ratio = 1.0

    def record(self, dt: float) -> bool:
        """Record one step duration; returns True if it straggled."""
        self.hist.record(dt)
        straggled = False
        hist = list(self._times)  # the window-1..window most recent PRIOR steps
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.threshold * med:
                ev = (self.hist.count - 1, dt, med)
                self._events.append(ev)
                self._n_events += 1
                self._worst_ratio = max(self._worst_ratio, dt / med)
                if self.on_straggle:
                    self.on_straggle(*ev)
                straggled = True
        self._times.append(dt)
        return straggled

    def snapshot(self) -> dict:
        """Immutable copy of the monitor's mutable state.

        ``_times``/``_events`` are mutated by ``record`` on the serve
        thread, so consumers get value-copied tuples, never an alias of
        the live deques.
        """
        return {
            "times": tuple(self._times),
            "events": tuple(self._events),
            "report": self.report(),
        }

    def report(self) -> dict:
        """Slow-step summary: rolling median, event totals, distribution.

        ``median_s`` is the rolling-window median (what the straggle
        threshold compares against); ``p50_s``/``p99_s``/``max_s`` read
        the whole-run histogram.
        """
        return {
            "steps": self.hist.count,
            "median_s": statistics.median(self._times) if self._times else 0.0,
            "straggle_events": self._n_events,
            "worst_ratio": self._worst_ratio,
            "p50_s": self.hist.percentile(50) or 0.0,
            "p99_s": self.hist.percentile(99) or 0.0,
            "max_s": self.hist.max if self.hist.count else 0.0,
        }
