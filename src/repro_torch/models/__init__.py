"""Models: the paper's CNNs (``cnn``) and the LM families.

:func:`get_model` is the JAX package's family registry: ``dense``, ``moe``
and ``vlm`` through :mod:`~repro_torch.models.transformer`, ``ssm``
through :mod:`~repro_torch.models.mamba2`, ``hybrid`` through
:mod:`~repro_torch.models.rglru`, ``encdec`` and ``audio`` through
:mod:`~repro_torch.models.encdec`::

    api = get_model(cfg)
    params = api.init_params(cfg, seed, device=...)
    loss = api.loss_fn(params, cfg, batch, remat=...)
    cache = api.init_cache(cfg, batch_size, max_len, device=...)
    logits, cache = api.prefill(params, cfg, batch, cache)
    logits, cache = api.decode_step(params, cfg, token, cache, pos)

``batch`` is a dict with ``"tokens"`` (and ``"labels"`` for the loss) and,
for a ``vlm``, ``encdec`` or ``audio`` model, ``"frontend"`` (precomputed
patch or frame embeddings, the stub frontend). ``loss_fn`` is the mean
next-token cross entropy, differentiable (each family's ``loss_fn``; the
attention in the reference's torch ops, no kernel). The cache is each
family's own: a KV cache, mamba2's ``(conv, ssd)`` state, rglru's
recurrent state and ring, and for enc-dec the ``(cache, enc_out)`` pair
that prefill returns. Over a model axis of more than one rank each family
runs on this rank's blocks of the parameters and takes its cache as
``api.tp_cache(cache, cfg, pctx)`` lays it out (``ServeSetup.layout``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable[..., Any]
    loss_fn: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    # tp_cache(cache, cfg, pctx): a whole cache's blocks on this rank of a model
    # axis of more than one rank
    tp_cache: Callable[..., Any]


def _tf_api() -> ModelApi:
    from repro_torch.models import transformer

    def loss(params, cfg, batch, *, pctx=None, remat=True):
        return transformer.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                                   frontend=batch.get("frontend"), pctx=pctx, remat=remat)

    def prefill(params, cfg, batch, cache, *, pctx=None):
        return transformer.prefill(params, cfg, batch["tokens"], cache,
                                   frontend=batch.get("frontend"), pctx=pctx)

    def decode(params, cfg, token, cache, pos, *, pctx=None):
        return transformer.decode_step(params, cfg, token, cache, pos, pctx=pctx)

    return ModelApi(transformer.init_params, loss, transformer.init_cache, prefill, decode,
                    transformer.tp_cache)


def _ssm_api() -> ModelApi:
    from repro_torch.models import mamba2

    def loss(params, cfg, batch, *, pctx=None, remat=True):
        return mamba2.loss_fn(params, cfg, batch["tokens"], batch["labels"], remat=remat,
                              pctx=pctx)

    def init_cache(cfg, batch, max_len, *, device=None):
        return mamba2.init_state(cfg, batch, device=device)

    def prefill(params, cfg, batch, cache, *, pctx=None):
        return mamba2.prefill(params, cfg, batch["tokens"], cache, pctx=pctx)

    def decode(params, cfg, token, cache, pos, *, pctx=None):
        return mamba2.decode_step(params, cfg, token, cache, pos, pctx=pctx)

    return ModelApi(mamba2.init_params, loss, init_cache, prefill, decode, mamba2.tp_state)


def _hybrid_api() -> ModelApi:
    from repro_torch.models import rglru

    def loss(params, cfg, batch, *, pctx=None, remat=True):
        return rglru.loss_fn(params, cfg, batch["tokens"], batch["labels"], remat=remat,
                             pctx=pctx)

    def prefill(params, cfg, batch, cache, *, pctx=None):
        return rglru.prefill(params, cfg, batch["tokens"], cache, pctx=pctx)

    def decode(params, cfg, token, cache, pos, *, pctx=None):
        return rglru.decode_step(params, cfg, token, cache, pos, pctx=pctx)

    return ModelApi(rglru.init_params, loss, rglru.init_cache, prefill, decode, rglru.tp_state)


def _encdec_api() -> ModelApi:
    from repro_torch.models import encdec, transformer

    def loss(params, cfg, batch, *, pctx=None, remat=True):
        return encdec.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                              frontend=batch["frontend"], pctx=pctx, remat=remat)

    def prefill(params, cfg, batch, cache, *, pctx=None):
        return encdec.prefill(params, cfg, batch["tokens"], cache, frontend=batch["frontend"],
                              pctx=pctx)

    def decode(params, cfg, token, cache, pos, *, pctx=None):
        return encdec.decode_step(params, cfg, token, cache, pos, pctx=pctx)

    return ModelApi(encdec.init_params, loss, encdec.init_cache, prefill, decode,
                    transformer.tp_cache)


_FAMILIES = {
    "dense": _tf_api,
    "moe": _tf_api,
    "vlm": _tf_api,
    "ssm": _ssm_api,
    "hybrid": _hybrid_api,
    "encdec": _encdec_api,
    "audio": _encdec_api,
}


def get_model(cfg) -> ModelApi:
    """The model API of ``cfg.family``."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} (known: {sorted(_FAMILIES)})")
    return _FAMILIES[cfg.family]()
