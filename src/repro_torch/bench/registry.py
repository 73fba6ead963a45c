"""Workload registry: named, deterministic benchmark specs.

The JAX package's ``repro/bench/registry.py``. A :class:`WorkloadSpec` is
one fully parameterised measurement (fixed shapes, fixed seeds). Specs
belong to a suite (``kernels`` / ``e2e``) and a tier:

  * ``smoke``: small shapes, cheap enough for every run of the suites;
  * ``full``: the real measurement shapes.

``--smoke`` selects the smoke tier; a full run executes both tiers, so a
full document holds every key a smoke run measures.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.bench.schema import SUITES, TIERS


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One named measurement.

    ``run(iters, warmup, device)`` returns the entry body: a dict with
    ``workload``, ``shape``, ``wall_us`` (impl-keyed timings), and the
    optional ``hlo`` / ``quality`` / ``bytes`` blocks
    (:mod:`repro_torch.bench.schema`).

    ``autotune_shape`` is the matmul problem this workload drives through
    the packed kernels, ``(m, k, n, fmt_name, nibble)`` (the im2col shape
    for a conv), declared at registration so the autotuner never reads it
    out of ``run``. ``None``: nothing to tune.
    """

    name: str
    suite: str
    tier: str
    run: Callable[..., dict]
    tags: tuple[str, ...] = ()
    autotune_shape: tuple[int, int, int, str, bool] | None = None

    def __post_init__(self):
        if self.suite not in SUITES:
            raise ValueError(f"unknown suite {self.suite!r} for {self.name!r}")
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r} for {self.name!r}")


_REGISTRY: dict[str, WorkloadSpec] = {}


def register(spec: WorkloadSpec) -> WorkloadSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate workload name {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> WorkloadSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def specs(
    suite: str | None = None, *, smoke_only: bool = False, only: str | None = None
) -> list[WorkloadSpec]:
    """Registered specs, name-sorted (run order is part of determinism)."""
    _ensure_loaded()
    out = []
    for name in sorted(_REGISTRY):
        s = _REGISTRY[name]
        if suite is not None and s.suite != suite:
            continue
        if smoke_only and s.tier != "smoke":
            continue
        if only is not None and only not in s.name:
            continue
        out.append(s)
    return out


def _ensure_loaded() -> None:
    # The workload definitions import the models and kernels, whose modules
    # import this package's autotune cache: registration waits for the
    # first query.
    from repro_torch.bench import workloads  # noqa: F401
