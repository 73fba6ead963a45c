"""Per-request span records, the JSONL event-log sink, and a profiler hook.

The port's copy of the JAX package's ``repro/obs/trace.py``. The span
model is the serve engine's request lifecycle::

    submit -> admit -> {decode | round}* -> finish

Each transition is one EVENT: a flat JSON object with the request id
(``rid``; batch-wide events like decode steps carry ``rid: null``), the
event name, a wall-clock timestamp (``time.perf_counter``, the clock the
latency histograms use) and event-specific attributes. Events are
appended to a JSONL sink as they happen.

:class:`ProfileHook` captures a ``torch.profiler`` trace (host ops and,
on the card, CUDA kernels) around the first N decode dispatches, where
the JAX package starts ``jax.profiler``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, IO

__all__ = ["TraceLog", "ProfileHook"]


class TraceLog:
    """Append-only JSONL event sink.

    ``sink`` is a path (opened for append; the common case), a
    file-like object (e.g. ``io.StringIO`` in tests), or ``None`` to
    buffer events in memory (``.events`` — handy for assertions).
    """

    def __init__(self, sink: str | IO[str] | None = None):
        self.events: list[dict] = []
        self._own = False
        self._fh: IO[str] | None = None
        if isinstance(sink, str):
            self._fh = open(sink, "a")
            self._own = True
        elif sink is not None:
            self._fh = sink
        self._t0 = time.perf_counter()

    def event(self, name: str, rid: int | None = None, **attrs: Any) -> dict:
        """Record one event; returns the event dict (already sunk)."""
        ev = {"t": time.perf_counter() - self._t0, "event": name, "rid": rid, **attrs}
        if self._fh is not None:
            self._fh.write(json.dumps(ev, sort_keys=True) + "\n")
        else:
            self.events.append(ev)
        return ev

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        self.flush()
        if self._own and self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TraceLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProfileHook:
    """Capture a ``torch.profiler`` trace around N decode dispatches.

    The engine calls :meth:`step` once per decode/round dispatch; the
    hook starts the profiler on the first call and stops it after
    ``n_steps``, writing a Chrome trace to ``<log_dir>/trace.json``.
    :attr:`profiler` keeps the finished profile (``key_averages()``).
    Inert after the window closes; safe to keep calling.
    """

    def __init__(self, log_dir: str, n_steps: int = 20):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.log_dir = log_dir
        self.n_steps = int(n_steps)
        self.seen = 0
        self.active = False
        self.done = False
        self.profiler = None

    def step(self) -> None:
        if self.done:
            return
        if not self.active:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=acts)
            self.profiler.start()
            self.active = True
        self.seen += 1
        if self.seen >= self.n_steps:
            self.stop()

    def stop(self) -> None:
        """Stop the capture early (idempotent; also the end-of-run hook)."""
        if self.active:
            self.profiler.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            self.profiler.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
            self.active = False
        self.done = True
