"""Lockstep LM generation over a dense KV cache: ``ServeSetup`` and ``static_generate``.

The part of the JAX package's ``repro/serve/engine.py`` that serves a
static batch: one whole-batch prefill, then lockstep decode steps, every
row at the same position. The decode step consumes the packed leaves
directly (codes in, decoded inside the matmul kernels), so device memory
moves code bytes, never a decoded weight tree.

Not ported yet (ROADMAP.md, queue 1 items 6 and 8): the continuous-batching
``ServeEngine`` with its slot scheduler, paged caches and speculative
drafters, and device meshes (``ServeSetup.mesh`` must be None).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import get_model

_NOT_PORTED = "not ported to repro_torch yet; see ROADMAP.md (queue 1 items 6 and 8)"


@dataclasses.dataclass(frozen=True)
class ServeSetup:
    """Static serving configuration: the cache geometry and its storage.

    ``kv_bits=8`` stores the dense cache as int8 codes against static
    per-(layer, head) scales. ``mesh`` must be None: device meshes are not
    ported, nor are the JAX package's paged-cache, flash-decode and MoE
    knobs (fields it has and this class does not).
    """

    cfg: ArchConfig
    mesh: object | None
    max_len: int
    batch: int
    kv_bits: int = 0

    def __post_init__(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(f"serving on a device mesh is {_NOT_PORTED}")
        if self.kv_bits not in (0, 8):
            raise ValueError(f"kv_bits is 0 (model dtype) or 8 (static int8), got {self.kv_bits}")


def static_generate(
    setup: ServeSetup,
    params,
    batch: dict,
    max_new_tokens: int,
    *,
    greedy: bool = True,
    generator: torch.Generator | None = None,
    kv_scales=None,
) -> torch.Tensor:
    """Greedy or sampled generation for a static (lockstep) batch of prompts.

    One whole-batch prefill of ``batch["tokens"] [B, S]``, then
    ``max_new_tokens - 1`` lockstep decode steps; returns the new tokens
    ``[B, max_new_tokens]`` (int32). ``kv_scales`` (calibrated
    ``([L, KV], [L, KV])``, :func:`repro_torch.calib.runner.calibrate_kv_cache`)
    or ``setup.kv_bits=8`` switches the cache to the dense static-int8
    layout. Sampling (``greedy=False`` with a ``generator``) draws from the
    ``torch.Generator``, whose bits are not ``jax.random``'s.
    """
    cfg = setup.cfg
    api = get_model(cfg)
    device = params["embed"].device
    if setup.kv_bits and kv_scales is None:
        raise ValueError("kv_bits=8 stores int8 codes against calibrated scales: pass kv_scales")
    if kv_scales is not None:
        cache = api.init_cache(cfg, setup.batch, setup.max_len, kv_scales=kv_scales, device=device)
    else:
        cache = api.init_cache(cfg, setup.batch, setup.max_len, device=device)
    tokens = torch.as_tensor(batch["tokens"]).to(device)
    if "frontend" in batch:
        raise NotImplementedError(f"modality frontends are {_NOT_PORTED}")
    logits, cache = api.prefill(params, cfg, {"tokens": tokens}, cache)
    pos = tokens.shape[1]
    out = [_pick(logits, greedy, generator)]
    for i in range(max_new_tokens - 1):
        logits, cache = api.decode_step(params, cfg, out[-1], cache, pos + i)
        out.append(_pick(logits, greedy, generator))
    return torch.cat(out, dim=1)


def _pick(logits: torch.Tensor, greedy: bool, generator: torch.Generator | None) -> torch.Tensor:
    """The next token ``[B, 1]`` (int32): argmax, or a draw from the softmax with ``generator``."""
    if greedy or generator is None:
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, -1].to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
