"""Deprecated static-batch serving entry points (see :mod:`repro_torch.serve.engine`).

The port of the JAX package's ``repro/runtime/serve_loop.py`` shim: the
serving engine lives in :mod:`repro_torch.serve.engine`, and this module
keeps the deprecation surface:

  * :class:`ServeSetup` is re-exported unchanged;
  * :func:`make_serve_fns` warns and delegates to
    :func:`repro_torch.serve.engine.build_serve_fns`;
  * :func:`generate` warns and serves through
    :func:`repro_torch.serve.engine.batch_generate` (the engine for greedy
    calls, the static lockstep loop for sampled ones).
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.serve.engine import ServeSetup, batch_generate, build_serve_fns

__all__ = ["ServeSetup", "make_serve_fns", "generate"]


def make_serve_fns(setup: ServeSetup, api=None):
    """Deprecated: the (prefill, decode) pair; use
    :func:`repro_torch.serve.engine.build_serve_fns`."""
    warnings.warn(
        "runtime.serve_loop.make_serve_fns is deprecated; use "
        "repro_torch.serve.engine.build_serve_fns",
        DeprecationWarning,
        stacklevel=2,
    )
    return build_serve_fns(setup, api)


def generate(setup: ServeSetup, params, batch: dict, max_new_tokens: int, *,
             greedy: bool = True, generator: torch.Generator | None = None) -> torch.Tensor:
    """Deprecated: generation for a batch of prompts; use
    :class:`repro_torch.serve.engine.ServeEngine` or
    :func:`repro_torch.serve.engine.static_generate`."""
    warnings.warn(
        "runtime.serve_loop.generate is deprecated; use repro_torch.serve.engine.ServeEngine "
        "(continuous batching) or repro_torch.serve.engine.static_generate",
        DeprecationWarning,
        stacklevel=2,
    )
    return batch_generate(setup.cfg, params, batch, max_new_tokens, mesh=setup.mesh,
                          max_len=setup.max_len, greedy=greedy, generator=generator,
                          flash_decode=setup.flash_decode)
