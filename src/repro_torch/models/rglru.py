"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local attention.

The JAX package's ``repro/models/rglru.py`` with the same parameter tree
and cache. The layer pattern repeats ``cfg.period`` (recurrentgemma-2b:
``("rec", "rec", "attn")``); the recurrent blocks' parameters are stacked
under ``"rec"`` and the attention blocks' under ``"attn"``, each in layer
order. Where the JAX package scans over pattern groups and unrolls the
tail, this module walks the layers in their order (the same blocks in the
same order).

RG-LRU (prefill: a scan over the positions, decode: a one-step update)::

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * softplus(lam) * r_t    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX package's ``lax.associative_scan`` over ``(a, b)`` pairs becomes a
doubling scan (log2(S) steps of whole-sequence products, no loop over
positions), in float32. ``wa``/``wx`` are float products (``jnp.dot`` in
the reference, not in ``QUANTIZABLE``); the block matmuls go through
:func:`~repro_torch.models.layers.matmul`. Attention layers are GQA with a
sliding window; a cache no longer than the window is a ring (slot = position
mod W), so decode state is O(window). The windowed attention stays
:func:`~repro_torch.models.layers.attention_dot` (the flash kernels take no
window and at most head_dim 128; recurrentgemma-2b's is 256). Caches are
written in place and returned.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import (
    NEG_INF,
    apply_rope,
    attention_chunked,
    attention_dot,
    causal_conv,
    cross_entropy,
    dense_init,
    init_device,
    init_generator,
    matmul,
    mlp_apply,
    repeat_kv,
    rms_norm,
    rope_embed,
    softplus,
)

F32 = torch.float32
LRU_C = 8.0


def _layer_kinds(cfg: ArchConfig) -> list[str]:
    return [cfg.period[i % len(cfg.period)] for i in range(cfg.n_layers)]


def _counts(cfg: ArchConfig) -> tuple[int, int, int, list[str]]:
    """``(n_groups, n_rec, n_attn, tail_kinds)``."""
    kinds = _layer_kinds(cfg)
    plen = len(cfg.period)
    g = cfg.n_layers // plen
    return (g, sum(k == "rec" for k in kinds), sum(k == "attn" for k in kinds),
            kinds[g * plen:])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_rec_stack(cfg: ArchConfig, gen: torch.Generator, n: int) -> dict:
    d, lru, ff = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.d_ff
    dt, device = cfg.dtype, init_device(gen)

    def stack(shape):
        out = torch.empty((n, *shape), dtype=dt, device=device)
        if gen is None:
            return out
        for i in range(n):
            out[i] = dense_init(gen, shape, dt)
        return out

    # lam so that a^(c softplus(lam)) sits in (0.9, 0.999) at r = 1 (the Griffin init)
    u = 0.9 + 0.099 * torch.rand((n, lru), generator=gen, dtype=F32, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / LRU_C))
    return {
        "ln1": torch.zeros((n, d), dtype=dt, device=device),
        "w_gate": stack((d, lru)),
        "w_rec": stack((d, lru)),
        "conv_w": stack((cfg.conv_width, lru)),
        "conv_b": torch.zeros((n, lru), dtype=dt, device=device),
        "wa": stack((lru, lru)),
        "ba": torch.zeros((n, lru), dtype=F32, device=device),
        "wx": stack((lru, lru)),
        "bx": torch.zeros((n, lru), dtype=F32, device=device),
        "lam": lam,
        "w_out": stack((lru, d)),
        "ln2": torch.zeros((n, d), dtype=dt, device=device),
        "w1": stack((d, ff)),
        "w3": stack((d, ff)),
        "w2": stack((ff, d)),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded parameters in the JAX package's tree, scales and dtypes, on ``device``
    (default: the card). The draws are a ``torch.Generator``'s, not ``jax.random``'s."""
    _, n_rec, n_attn, _ = _counts(cfg)
    device = resolve_device(device)
    gen = init_generator(device, seed)
    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype),
        "rec": _init_rec_stack(cfg, gen, n_rec),
        "attn": T.init_block_params(cfg, gen, n_attn),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype),
    }


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along dim 1, as a doubling scan.

    Step ``k`` composes each position with the one ``2^k`` before it:
    ``(a, b)_t <- (a_{t-d} a_t, a_t b_{t-d} + b_t)``, the associative
    combine of the JAX package's ``lax.associative_scan``.
    """
    d = 1
    while d < a.shape[1]:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return b


def _rg_lru(lp: dict, x: torch.Tensor, h0: torch.Tensor | None):
    """``x [B, S, lru]`` (after the conv) -> ``(y, final h [B, lru])``."""
    with full_f32():
        xf = x.to(F32)
        r = torch.sigmoid(torch.matmul(xf, lp["wa"].to(F32)) + lp["ba"])
        i = torch.sigmoid(torch.matmul(xf, lp["wx"].to(F32)) + lp["bx"])
    log_a = -LRU_C * softplus(lp["lam"])[None, None] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)
    if x.shape[1] == 1 and h0 is not None:
        h = a[:, 0] * h0 + b[:, 0]
        return h[:, None].to(x.dtype), h
    if h0 is not None:
        b = torch.cat([b[:, :1] + (a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    hs = _scan(a, b)
    return hs.to(x.dtype), hs[:, -1]


def rec_block(lp: dict, cfg: ArchConfig, x: torch.Tensor, state: tuple | None = None):
    """Recurrent block + MLP. ``state = (conv window [B, cw-1, lru], h [B, lru])``
    (decode for one token, prefill from that context for more); returns
    ``(x, new_state or None)``."""
    xn = rms_norm(x, lp["ln1"])
    gate = F.gelu(matmul(xn, lp["w_gate"]).to(F32), approximate="tanh").to(x.dtype)
    y = matmul(xn, lp["w_rec"])
    new_state = None
    if state is None:
        y, _ = _rg_lru(lp, causal_conv(y, lp["conv_w"], lp["conv_b"]), None)
    else:
        conv_win, h0 = state
        cw = cfg.conv_width
        ypad = torch.cat([conv_win.to(y.dtype), y], dim=1)
        new_win = ypad[:, -(cw - 1):].to(conv_win.dtype)
        y = causal_conv(y, lp["conv_w"], lp["conv_b"], left=conv_win)
        y, h = _rg_lru(lp, y, h0)
        new_state = (new_win, h)
    x = x + matmul(y * gate, lp["w_out"])
    return x + mlp_apply(lp, rms_norm(x, lp["ln2"]), "geglu"), new_state


# ---------------------------------------------------------------------------
# Local attention over a ring cache
# ---------------------------------------------------------------------------
def _ring_qkv(lp: dict, cfg: ArchConfig, xn: torch.Tensor, positions: torch.Tensor):
    b, s, _ = xn.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(xn, lp["wq"]).reshape(b, s, h, hd)
    k = matmul(xn, lp["wk"]).reshape(b, s, kv, hd)
    v = matmul(xn, lp["wv"]).reshape(b, s, kv, hd)
    cos, sin = rope_embed(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _ring_prefill(lp: dict, cfg: ArchConfig, xn: torch.Tensor, kv_cache: tuple):
    """Windowed prefill from position 0: local attention over the S tokens, then
    the ring filled with the last W keys/values (slot of position p: p mod W)."""
    ck, cv = kv_cache
    w = ck.shape[1]
    b, s, _ = xn.shape
    q, k, v = _ring_qkv(lp, cfg, xn, torch.arange(s, device=xn.device)[None])
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kf, vf = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if s >= T.CHUNKED_ATTN_THRESHOLD:
        out = attention_chunked(q, kf, vf, causal=True, window=cfg.window, chunk=T.ATTN_CHUNK)
    else:
        out = attention_dot(q, kf, vf, causal=True, window=cfg.window)
    if s >= w:
        ck.copy_(torch.roll(k[:, -w:], s % w, dims=1))
        cv.copy_(torch.roll(v[:, -w:], s % w, dims=1))
    else:
        ck[:, :s] = k
        cv[:, :s] = v
    return matmul(out.reshape(b, s, -1), lp["wo"]), (ck, cv)


def _ring_decode(lp: dict, cfg: ArchConfig, xn: torch.Tensor, kv_cache: tuple, pos: int):
    """One token a row at position ``pos`` against the W-slot ring."""
    ck, cv = kv_cache
    w = ck.shape[1]
    b = xn.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = _ring_qkv(lp, cfg, xn, torch.full((1, 1), pos, device=xn.device))
    slot = pos % w
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    # the absolute position held in slot i: p_i = pos - ((pos - i) mod W)
    i = torch.arange(w, device=xn.device)
    valid = pos - torch.remainder(pos - i, w) >= 0
    kf = ck.to(F32).repeat_interleave(h // kv, dim=2)  # [B, W, H, hd]
    vf = cv.to(F32).repeat_interleave(h // kv, dim=2)
    with full_f32():
        logits = torch.einsum("bqhd,bwhd->bhqw", q.to(F32), kf) / math.sqrt(hd)
        logits = torch.where(valid[None, None, None, :], logits,
                             torch.tensor(NEG_INF, dtype=F32, device=xn.device))
        out = torch.einsum("bhqw,bwhd->bqhd", torch.softmax(logits, dim=-1), vf).to(xn.dtype)
    return matmul(out.reshape(b, 1, -1), lp["wo"]), (ck, cv)


def attn_block(lp: dict, cfg: ArchConfig, x: torch.Tensor, *, rope, kv_cache=None,
               cache_pos=None, attn_impl: str = "flash"):
    """Local-attention block + MLP. A cache no longer than the window is a ring;
    any other cache (or none) takes the transformer's attention with the window
    (``attn_impl`` as in :func:`repro_torch.models.transformer._attention`)."""
    ring = kv_cache is not None and cfg.window > 0 and kv_cache[0].shape[1] <= cfg.window
    xn = rms_norm(x, lp["ln1"])
    if ring:
        if x.shape[1] == 1:
            out, new_cache = _ring_decode(lp, cfg, xn, kv_cache, T._as_pos(cache_pos))
        else:
            out, new_cache = _ring_prefill(lp, cfg, xn, kv_cache)
    else:
        out, new_cache = T._attention(lp, cfg, xn, rope=rope, causal=True, window=cfg.window,
                                      kv_cache=kv_cache, cache_pos=cache_pos,
                                      attn_impl=attn_impl)
    x = x + out
    return x + mlp_apply(lp, rms_norm(x, lp["ln2"]), cfg.mlp_kind), new_cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------
def _run(params, cfg: ArchConfig, x: torch.Tensor, cache: dict | None = None, cache_pos=None,
         *, remat: bool = False, attn_impl: str = "flash"):
    """Every layer in its order; with ``cache`` each block's state is written in place.
    Without a cache, ``remat`` recomputes each block in the backward pass."""
    if remat and cache is not None:
        raise ValueError("remat is for the cache-less forward")
    s = x.shape[1]
    ar = torch.arange(s, device=x.device)
    positions = (ar if cache_pos is None else T._as_pos(cache_pos) + ar)[None, :]
    cos, sin = rope_embed(positions, cfg.hd, cfg.rope_theta)
    rope = (cos, sin, cos, sin)
    ri = ai = 0
    for kind in _layer_kinds(cfg):
        if kind == "rec":
            lp = T.layer_params(params["rec"], ri)
            if cache is None:
                block = lambda lp_, x_: rec_block(lp_, cfg, x_)[0]  # noqa: E731
                x = T.remat_call(block, lp, x) if remat else block(lp, x)
            else:
                x, new = rec_block(lp, cfg, x, state=(cache["conv"][ri], cache["h"][ri]))
                cache["conv"][ri], cache["h"][ri] = new
            ri += 1
        else:
            lp = T.layer_params(params["attn"], ai)
            kvc = (cache["k"][ai], cache["v"][ai]) if cache is not None else None
            block = lambda lp_, x_: attn_block(lp_, cfg, x_, rope=rope, kv_cache=kvc,  # noqa: E731
                                               cache_pos=cache_pos, attn_impl=attn_impl)[0]
            x = T.remat_call(block, lp, x) if remat else block(lp, x)
            ai += 1
    return x, cache


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None) -> dict:
    """Recurrent state and the attention layers' caches on ``device`` (default: the card).

    Local attention never looks farther back than the window, so the KV
    cache has ``min(max_len, window)`` slots: a ring when the window binds.
    """
    _, n_rec, n_attn, _ = _counts(cfg)
    device = resolve_device(device)
    lru = cfg.lru_width or cfg.d_model
    kv_len = min(max_len, cfg.window or max_len)
    kv_shape = (n_attn, batch, kv_len, cfg.n_kv_heads, cfg.hd)
    return {
        "conv": torch.zeros((n_rec, batch, cfg.conv_width - 1, lru), dtype=cfg.dtype,
                            device=device),
        "h": torch.zeros((n_rec, batch, lru), dtype=F32, device=device),
        "k": torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
    }


def forward(params, cfg: ArchConfig, tokens, **_) -> torch.Tensor:
    """Cache-less forward without gradients: float32 logits ``[B, S, V]``."""
    with torch.no_grad():
        x, _ = _run(params, cfg, T.embed_tokens(params, cfg, tokens))
        return T.unembed(params, cfg, x)


def loss_fn(params, cfg: ArchConfig, tokens, labels, *, remat: bool = True, **_) -> torch.Tensor:
    """Mean next-token cross entropy of the cache-less forward, differentiable:
    attention in the reference's torch ops, each block recomputed in the backward
    pass with ``remat``."""
    x, _ = _run(params, cfg, T.embed_tokens(params, cfg, tokens), remat=remat,
                attn_impl="reference")
    return cross_entropy(T.unembed(params, cfg, x), labels)


def prefill(params, cfg: ArchConfig, tokens, cache: dict, **_):
    """The prompt from position 0 into ``cache``; the last position's logits and the cache."""
    with torch.no_grad():
        x, cache = _run(params, cfg, T.embed_tokens(params, cfg, tokens), cache=cache,
                        cache_pos=0)
        return T.unembed(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ArchConfig, token, cache: dict, pos, **_):
    """One token a row at position ``pos`` (a scalar) -> ``[B, 1, V]`` logits."""
    with torch.no_grad():
        x, cache = _run(params, cfg, T.embed_tokens(params, cfg, token), cache=cache,
                        cache_pos=pos)
        return T.unembed(params, cfg, x), cache
