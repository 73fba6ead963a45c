"""Shared measurement harness: timings, step cost, output error.

The JAX package's ``repro/bench/harness.py``. One workload measurement
produces:

  * ``wall_us``: median and minimum microseconds of a call after warmup
    calls, per execution variant. On the card each call is timed by CUDA
    events recorded after a ``synchronize`` (the reference blocks on
    ``jax.block_until_ready``); on the CPU by ``perf_counter``.
  * ``hlo``: FLOPs, bytes accessed and collective wire bytes of one call,
    counted by :func:`repro_torch.launch.hlo_stats.count_cost` (the
    reference reads XLA's cost analysis of the compiled graph).
  * ``quality``: workload-defined fidelity numbers, so a speed-up that
    costs accuracy shows in the same document.

:func:`device_time_us` is the autotuner's clock: on the card the median of
launches that each start with a cold L2 behind a device sleep, so it is
the device's time for the work alone (``chip_smoke.py``'s ``timed_ms``).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

L2_FLUSH_BYTES = 128 << 20  # twice the H100's 50 MB L2: each timed launch starts cold
SLEEP_CYCLES = 2_000_000  # about 1 ms: longer than the host takes to launch a timed call


@dataclasses.dataclass(frozen=True)
class Timing:
    median_us: float
    min_us: float
    iters: int
    warmup: int

    def to_json(self) -> dict:
        return {
            "median_us": round(self.median_us, 2),
            "min_us": round(self.min_us, 2),
            "iters": self.iters,
            "warmup": self.warmup,
        }


def _elapsed_s(fn: Callable[[], Any], device: torch.device) -> float:
    """Seconds of one ``fn()``: CUDA events after a synchronize on the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _timing(ts: list[float], iters: int, warmup: int) -> Timing:
    return Timing(float(np.median(ts) * 1e6), float(np.min(ts) * 1e6), iters, warmup)


def time_fn(fn: Callable[[], Any], *, iters: int = 5, warmup: int = 2, device=None) -> Timing:
    """Median/min microseconds of ``fn()`` on ``device`` (default: the card)."""
    device = resolve_device(device)
    for _ in range(warmup):
        fn()
    return _timing([_elapsed_s(fn, device) for _ in range(iters)], iters, warmup)


def time_fn_pair(
    fn_a: Callable[[], Any], fn_b: Callable[[], Any], *, iters: int = 5, warmup: int = 2,
    device=None,
) -> tuple[Timing, Timing]:
    """Interleaved A/B timing: one call of each per iteration, so slow drift of
    the machine lands on both sides alike (for a RATIO of the two timings)."""
    device = resolve_device(device)
    for _ in range(warmup):
        fn_a()
        fn_b()
    ts_a: list[float] = []
    ts_b: list[float] = []
    for _ in range(iters):
        ts_a.append(_elapsed_s(fn_a, device))
        ts_b.append(_elapsed_s(fn_b, device))
    return _timing(ts_a, iters, warmup), _timing(ts_b, iters, warmup)


def device_time_us(fn: Callable[[], Any], *, iters: int = 7, warmup: int = 1,
                   device=None) -> float:
    """Median microseconds of ``fn()`` over ``iters`` calls after ``warmup``.

    On the card each call starts with a cold L2 (a 128 MB buffer zeroed
    first) and waits behind a device sleep, so the events time the device's
    work alone, not the host's launch overhead. On the CPU: ``perf_counter``.
    """
    device = resolve_device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        return statistics.median(_elapsed_s(fn, device) for _ in range(iters)) * 1e6
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def hlo_cost(fn: Callable, *args, **kwargs) -> dict:
    """FLOPs, bytes accessed and collective wire bytes of one ``fn(*args, **kwargs)``.

    Runs the call once under :func:`repro_torch.launch.hlo_stats.count_cost`
    (with ``meta`` arguments it is counted, never computed) and returns the
    reference's keys.
    """
    from repro_torch.launch.hlo_stats import count_cost

    with torch.no_grad(), count_cost() as c:
        fn(*args, **kwargs)
    return {"flops": c.flops, "bytes_accessed": c.bytes_accessed,
            "collective_bytes": c.collective_bytes}


def output_mse(got, want) -> float:
    def f64(a):
        return (a.detach().cpu().to(torch.float64).numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a, np.float64))

    return float(np.mean((f64(got) - f64(want)) ** 2))


# The Table II per-token energy helpers live with the rest of the analytic
# model in core/energy (the engine charges them per decoded token); re-exported
# as the reference's harness does.
from repro_torch.core.energy import lm_token_energy, lm_weight_macs_per_token  # noqa: E402,F401
