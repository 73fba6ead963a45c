"""Encoder-decoder transformer (the seamless-m4t backbone): the ``encdec`` and ``audio`` families.

The JAX package's ``repro/models/encdec.py`` with the same parameter tree.
The modality frontend is the reference's stub: the caller hands over
precomputed frame embeddings ``[B, S_enc, D]``, which ``frontend_proj``
maps into a bidirectional encoder stack; the decoder is a causal stack
whose blocks add cross-attention over the encoder output
(:func:`repro_torch.models.transformer.block_apply` with ``enc_out``).

The serve state is ``(cache, enc_out)``: the decoder's dense KV cache
(written in place) and the encoder output, which each decode step's
cross-attention reads through ``xk``/``xv`` again, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import cross_entropy, dense_init, matmul, rms_norm


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded parameters in the JAX package's tree, scales and dtype, on ``device``
    (default: the card). The draws are a ``torch.Generator``'s, not ``jax.random``'s."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)  # noqa: E731
    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype),
        "frontend_proj": dense_init(gen, (cfg.d_model, cfg.d_model), cfg.dtype),
        "encoder": T.init_block_params(cfg, gen, cfg.n_layers),
        "enc_norm": zeros(),
        "decoder": T.init_block_params(cfg, gen, cfg.n_dec_layers, cross=True),
        "final_norm": zeros(),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype),
    }


def encode(params, cfg: ArchConfig, src, *, remat: bool = False,
           attn_impl: str = "flash") -> torch.Tensor:
    """``src``: precomputed frame embeddings ``[B, S_enc, D]`` (the stub frontend)
    -> the normed encoder output ``[B, S_enc, D]``. ``remat`` and ``attn_impl`` as
    in :func:`repro_torch.models.transformer.stack_apply`."""
    src = torch.as_tensor(src).to(params["embed"].device).to(cfg.dtype)
    x, _ = T.stack_apply(params["encoder"], cfg, matmul(src, params["frontend_proj"]),
                         causal=False, remat=remat, attn_impl=attn_impl)
    return rms_norm(x, params["enc_norm"])


def forward(params, cfg: ArchConfig, tokens, *, frontend, **_) -> torch.Tensor:
    """Cache-less forward: float32 logits ``[B, S, V]``."""
    with torch.no_grad():
        enc_out = encode(params, cfg, frontend)
        x, _ = T.stack_apply(params["decoder"], cfg, T.embed_tokens(params, cfg, tokens),
                             causal=True, enc_out=enc_out)
        return T.unembed(params, cfg, x)


def loss_fn(params, cfg: ArchConfig, tokens, labels, *, frontend, remat: bool = True,
            **_) -> torch.Tensor:
    """Mean next-token cross entropy of the decoder over the encoded ``frontend``,
    differentiable: attention in the reference's torch ops in both stacks, each
    block recomputed in the backward pass with ``remat``."""
    enc_out = encode(params, cfg, frontend, remat=remat, attn_impl="reference")
    x, _ = T.stack_apply(params["decoder"], cfg, T.embed_tokens(params, cfg, tokens),
                         causal=True, enc_out=enc_out, remat=remat, attn_impl="reference")
    return cross_entropy(T.unembed(params, cfg, x), labels)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None) -> dict:
    """The decoder's dense KV cache ``[n_dec_layers, B, max_len, KV, hd]``."""
    return T.init_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg: ArchConfig, tokens, cache: dict, *, frontend, **_):
    """Encode the source and fill the decoder cache with the prompt; returns the last
    position's logits and the serve state ``(cache, enc_out)``."""
    with torch.no_grad():
        enc_out = encode(params, cfg, frontend)
        x, cache = T.stack_apply(params["decoder"], cfg, T.embed_tokens(params, cfg, tokens),
                                 causal=True, cache=cache, cache_pos=0, enc_out=enc_out)
        return T.unembed(params, cfg, x[:, -1:]), (cache, enc_out)


def decode_step(params, cfg: ArchConfig, token, state, pos, **_):
    """One token a row at position ``pos`` (a scalar or a ``[B]`` vector) against the
    serve state ``(cache, enc_out)``; returns ``[B, s, V]`` logits and the state."""
    cache, enc_out = state
    with torch.no_grad():
        x = T.embed_tokens(params, cfg, token)
        pos, positions = T.step_positions(pos, token.shape[1], x.device)
        x, cache = T.stack_apply(params["decoder"], cfg, x, causal=True, positions=positions,
                                 cache=cache, cache_pos=pos, enc_out=enc_out)
        return T.unembed(params, cfg, x), (cache, enc_out)
