"""Models: the paper's CNNs (``cnn``) and the decoder LM (``transformer``, ``moe``).

:func:`get_model` is the JAX package's family registry, for the families
ported so far (``dense``, ``moe`` and ``vlm``, all through
:mod:`~repro_torch.models.transformer`)::

    api = get_model(cfg)
    params = api.init_params(cfg, seed, device=...)
    cache = api.init_cache(cfg, batch_size, max_len, device=...)
    logits, cache = api.prefill(params, cfg, batch, cache)
    logits, cache = api.decode_step(params, cfg, token, cache, pos)

``batch`` is a dict with ``"tokens"`` and, for a ``vlm`` model,
``"frontend"`` (precomputed patch embeddings, the stub frontend). The
``ssm``, ``hybrid``, ``encdec`` and ``audio`` families raise
(ROADMAP.md, queue 1 item 5, next); ``loss_fn`` raises until training is
ported (queue 1 item 6).
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


def _tf_api() -> ModelApi:
    from repro_torch.models import transformer

    def loss(*args, **kwargs):
        raise NotImplementedError(
            "training (loss_fn) is not ported to repro_torch yet; see ROADMAP.md (queue 1 item 6)"
        )

    def prefill(params, cfg, batch, cache, *, pctx=None):
        return transformer.prefill(params, cfg, batch["tokens"], cache,
                                   frontend=batch.get("frontend"), pctx=pctx)

    def decode(params, cfg, token, cache, pos, *, pctx=None):
        return transformer.decode_step(params, cfg, token, cache, pos, pctx=pctx)

    return ModelApi(transformer.init_params, loss, transformer.init_cache, prefill, decode)


_FAMILIES = {"dense": _tf_api, "moe": _tf_api, "vlm": _tf_api}


def get_model(cfg) -> ModelApi:
    """The model API of ``cfg.family``; families not ported yet raise."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to repro_torch yet (ported: "
            f"{sorted(_FAMILIES)}); see ROADMAP.md (queue 1 item 5, next)"
        )
    return _FAMILIES[cfg.family]()
