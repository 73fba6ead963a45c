"""Benchmark subsystem: registry-run workloads, run documents, the gate and the autotuner.

The JAX package's ``repro/bench/`` on the port. Entry points:

  * ``python -m repro_torch.bench [--smoke]``: run the suites on the card
    (``--device cpu`` for the host), write ``BENCH_kernels.json`` /
    ``BENCH_e2e.json`` under ``build/bench/`` (see ``--help``);
  * ``python -m repro_torch.bench --autotune``: time the kernels at every
    registered shape first and write the cache;
  * ``quantized_matmul(..., impl="auto", block_sizes="auto")`` and
    flash-decode's ``block_s=None`` read that cache
    (:mod:`repro_torch.bench.autotune`).
"""
from repro_torch.bench.autotune import DEFAULT_BLOCKS, autotune_matmul, lookup_blocks
from repro_torch.bench.registry import WorkloadSpec, register, specs
from repro_torch.bench.schema import SCHEMA_VERSION, SchemaError, validate

__all__ = [
    "DEFAULT_BLOCKS",
    "SCHEMA_VERSION",
    "SchemaError",
    "WorkloadSpec",
    "autotune_matmul",
    "lookup_blocks",
    "register",
    "specs",
    "validate",
]
