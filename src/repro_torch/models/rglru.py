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

Over a model axis of more than one rank (``pctx``) a recurrent block runs on
the rank's channels of the recurrence (:func:`lru_block`: the rules' column
block of ``w_gate``, ``w_rec`` and ``conv_w``, or every channel where the axis
does not divide them); the gates' ``wa``/``wx`` are
column-parallel on the conv output gathered whole, ``w_out`` row-parallel.
An attention block runs the rank's query heads with the KV heads they read
(a KV head split by ``wk``'s column block is gathered whole and shared), its
output projection row-parallel; the MLPs are tensor parallel
(:func:`~repro_torch.models.layers.tp_mlp`). The cache holds the rank's
channels and KV heads (:func:`tp_state`).
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
    TPInput,
    apply_rope,
    attention_chunked,
    attention_dot,
    causal_conv,
    cross_entropy,
    dense_init,
    init_device,
    init_generator,
    local_kn,
    matmul,
    mlp_apply,
    repeat_kv,
    rms_norm,
    rope_embed,
    row_blocks,
    softplus,
    tp_active,
    tp_full,
    tp_matmul,
    tp_mlp,
    tp_residual,
    tp_take,
)
from repro_torch.runtime import collectives

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


def lru_block(cfg: ArchConfig, pctx=None) -> tuple[int, int]:
    """``[lo, hi)``: this rank's channels of the recurrence, the rules' block of
    ``w_rec``'s and ``conv_w``'s columns where ``lru_width`` divides the model axis
    (every channel otherwise, and without a model axis)."""
    lru = cfg.lru_width or cfg.d_model
    if not tp_active(pctx) or lru % pctx.model_size:
        return 0, lru
    n = lru // pctx.model_size
    return pctx.model_rank * n, (pctx.model_rank + 1) * n


def _channels(y: torch.Tensor, form: str, lo: int, hi: int, pctx, dtype) -> torch.Tensor:
    """Channels ``[lo, hi)`` of a product's output ``(y, form)``
    (:func:`~repro_torch.models.layers.tp_matmul`): its column block where that is
    the block, else taken from the whole output (all of it where the block is
    every channel: each rank then carries the whole gradient, to be summed by no
    one)."""
    if form == "cols" and y.shape[-1] == hi - lo:
        return y
    y = tp_full(y, form, pctx, dtype)
    return y if hi - lo == y.shape[-1] else tp_take(y, -1, lo, hi, pctx)


def _rg_lru(lp: dict, x: torch.Tensor, h0: torch.Tensor | None, pctx=None,
            block: tuple[int, int] | None = None):
    """``x [B, S, lru]`` (after the conv) -> ``(y, final h [B, lru])``. Over a model
    axis ``x`` and ``h0`` are this rank's ``block`` of the channels
    (:func:`lru_block`; None: every channel): the gates' products,
    column-parallel on the gathered whole ``x``, give its channels of ``r`` and
    ``i``, and the recurrence runs on them alone."""
    lru = lp["wa"].shape[-2]
    lo, hi = block or (0, lru)
    whole = hi - lo == lru

    def share(t):  # the block of a replicated per-channel weight
        return t if whole else tp_take(t, -1, lo, hi, pctx)

    with full_f32():
        xf = x.to(F32)
        inp = TPInput(xf if whole else collectives.gather_from_model(xf, -1, pctx.model_group),
                      pctx)

        def gate(w, bias):
            y, form = tp_matmul(inp, lp[w], lru, lru, pctx, f32=True)
            return torch.sigmoid(_channels(y, form, lo, hi, pctx, F32) + share(lp[bias]))

        r, i = gate("wa", "ba"), gate("wx", "bx")
        lam = share(lp["lam"])
    log_a = -LRU_C * softplus(lam)[None, None] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)
    if x.shape[1] == 1 and h0 is not None:
        h = a[:, 0] * h0 + b[:, 0]
        return h[:, None].to(x.dtype), h
    if h0 is not None:
        b = torch.cat([b[:, :1] + (a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    hs = _scan(a, b)
    return hs.to(x.dtype), hs[:, -1]


def rec_block(lp: dict, cfg: ArchConfig, x: torch.Tensor, state: tuple | None = None,
              pctx=None):
    """Recurrent block + MLP. ``state = (conv window [B, cw-1, lru], h [B, lru])``
    (decode for one token, prefill from that context for more); returns
    ``(x, new_state or None)``. Over a model axis the block runs on this rank's
    channels (:func:`lru_block`), its state holds them, ``w_out`` is
    row-parallel and the MLP tensor parallel."""
    d, lru = cfg.d_model, cfg.lru_width or cfg.d_model
    lo, hi = lru_block(cfg, pctx)
    whole = hi - lo == lru
    inp = TPInput(rms_norm(x, lp["ln1"]), pctx)

    def channels(name):
        y, form = tp_matmul(inp, lp[name], d, lru, pctx)
        return _channels(y, form, lo, hi, pctx, x.dtype)

    gate = F.gelu(channels("w_gate").to(F32), approximate="tanh").to(x.dtype)
    y = channels("w_rec")
    conv_b = lp["conv_b"] if whole else tp_take(lp["conv_b"], -1, lo, hi, pctx)
    new_state = None
    if state is None:
        y, _ = _rg_lru(lp, causal_conv(y, lp["conv_w"], conv_b), None, pctx, (lo, hi))
    else:
        conv_win, h0 = state
        new_win = torch.cat([conv_win.to(y.dtype), y], dim=1)[:, -(cfg.conv_width - 1):]
        y = causal_conv(y, lp["conv_w"], conv_b, left=conv_win)
        y, h = _rg_lru(lp, y, h0, pctx, (lo, hi))
        new_state = (new_win.to(conv_win.dtype), h)
    y, w = y * gate, lp["w_out"]
    if whole:
        out, form = tp_matmul(TPInput(y, pctx), w, lru, d, pctx)
    elif local_kn(w)[0] == hi - lo and row_blocks(w, lru, pctx.model_size) == [
            hi - lo] * pctx.model_size:
        out, form = matmul(y, w, f32=True), "partial"
    else:
        y = collectives.gather_from_model(y, -1, pctx.model_group)
        out, form = tp_matmul(TPInput(y, pctx), w, lru, d, pctx)
    x = x + tp_residual(out, form, pctx, False, x.dtype)
    out, form = tp_mlp(lp, TPInput(rms_norm(x, lp["ln2"]), pctx), "geglu", d, cfg.d_ff, pctx,
                       x.dtype)
    return x + tp_residual(out, form, pctx, False, x.dtype), new_state


def tp_state(cache: dict, cfg: ArchConfig, pctx) -> dict:
    """A whole hybrid cache's layout on this rank over a model axis: the recurrent
    ``conv`` and ``h`` states' channel block (:func:`lru_block`, the reference's
    ``cache_spec``: the widest trailing dim over the model axis), the ring's KV
    heads that this rank's query heads read (``transformer.head_blocks``; a KV
    head that the ranks share is whole on each)."""
    lo, hi = lru_block(cfg, pctx)
    _, _, kv_lo, kv_hi = T.head_blocks(cfg, pctx)
    return {"conv": cache["conv"][..., lo:hi].contiguous(), "h": cache["h"][..., lo:hi].contiguous(),
            "k": cache["k"][:, :, :, kv_lo:kv_hi].contiguous(),
            "v": cache["v"][:, :, :, kv_lo:kv_hi].contiguous()}


# ---------------------------------------------------------------------------
# Local attention over a ring cache
# ---------------------------------------------------------------------------
def _ring_qkv(lp: dict, cfg: ArchConfig, xn: torch.Tensor, positions: torch.Tensor,
              pctx=None):
    """Roped ``q``, ``k`` and ``v`` and the KV head each query head reads (None for
    the plain GQA grouping): over a model axis this rank's heads
    (``transformer._tp_heads``)."""
    b, s, _ = xn.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if tp_active(pctx):
        q, k, v, kv_idx = T._tp_heads(lp, cfg, TPInput(xn, pctx), pctx, "w")
    else:
        q = matmul(xn, lp["wq"]).reshape(b, s, h, hd)
        k = matmul(xn, lp["wk"]).reshape(b, s, kv, hd)
        v = matmul(xn, lp["wv"]).reshape(b, s, kv, hd)
        kv_idx = None
    cos, sin = rope_embed(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, kv_idx


def _per_head(t: torch.Tensor, h: int, kv_idx) -> torch.Tensor:
    """``t[B, S, KV, hd]`` as each of the ``h`` query heads reads it."""
    return t[:, :, kv_idx] if kv_idx is not None else repeat_kv(t, T.per_kv(h, t.shape[2]))


def _ring_prefill(lp: dict, cfg: ArchConfig, xn: torch.Tensor, kv_cache: tuple, pctx=None):
    """Windowed prefill from position 0: local attention over the S tokens, then
    the ring filled with the last W keys/values (slot of position p: p mod W).
    Returns the attention mix ``[B, S, heads * hd]`` and the cache."""
    ck, cv = kv_cache
    w = ck.shape[1]
    b, s, _ = xn.shape
    q, k, v, kv_idx = _ring_qkv(lp, cfg, xn, torch.arange(s, device=xn.device)[None], pctx)
    kf, vf = _per_head(k, q.shape[2], kv_idx), _per_head(v, q.shape[2], kv_idx)
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
    return out.reshape(b, s, -1), (ck, cv)


def _ring_decode(lp: dict, cfg: ArchConfig, xn: torch.Tensor, kv_cache: tuple, pos: int,
                 pctx=None):
    """One token a row at position ``pos`` against the W-slot ring; returns the
    attention mix ``[B, 1, heads * hd]`` and the cache."""
    ck, cv = kv_cache
    w = ck.shape[1]
    b = xn.shape[0]
    q, k, v, kv_idx = _ring_qkv(lp, cfg, xn, torch.full((1, 1), pos, device=xn.device), pctx)
    slot = pos % w
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    # the absolute position held in slot i: p_i = pos - ((pos - i) mod W)
    i = torch.arange(w, device=xn.device)
    valid = pos - torch.remainder(pos - i, w) >= 0
    kf = _per_head(ck.to(F32), q.shape[2], kv_idx)  # [B, W, H, hd]
    vf = _per_head(cv.to(F32), q.shape[2], kv_idx)
    with full_f32():
        logits = torch.einsum("bqhd,bwhd->bhqw", q.to(F32), kf) / math.sqrt(cfg.hd)
        logits = torch.where(valid[None, None, None, :], logits,
                             torch.tensor(NEG_INF, dtype=F32, device=xn.device))
        out = torch.einsum("bhqw,bwhd->bqhd", torch.softmax(logits, dim=-1), vf).to(xn.dtype)
    return out.reshape(b, 1, -1), (ck, cv)


def attn_block(lp: dict, cfg: ArchConfig, x: torch.Tensor, *, rope, kv_cache=None,
               cache_pos=None, attn_impl: str = "flash", pctx=None):
    """Local-attention block + MLP. A cache no longer than the window is a ring;
    any other cache (or none) takes the transformer's attention with the window
    (``attn_impl`` as in :func:`repro_torch.models.transformer._attention`). Over a
    model axis the heads are this rank's, the output projection row-parallel on
    them and the MLP tensor parallel."""
    ring = kv_cache is not None and cfg.window > 0 and kv_cache[0].shape[1] <= cfg.window
    tp = tp_active(pctx)
    xn = rms_norm(x, lp["ln1"])
    if ring:
        if x.shape[1] == 1:
            mix, new_cache = _ring_decode(lp, cfg, xn, kv_cache, T._as_pos(cache_pos), pctx)
        else:
            mix, new_cache = _ring_prefill(lp, cfg, xn, kv_cache, pctx)
        out = T._tp_out(mix, lp, cfg, pctx, "w") if tp else matmul(mix, lp["wo"])
    else:
        out, new_cache = T._attention(lp, cfg, None if tp else xn, rope=rope, causal=True,
                                      window=cfg.window, kv_cache=kv_cache, cache_pos=cache_pos,
                                      attn_impl=attn_impl, pctx=pctx,
                                      tp_in=TPInput(xn, pctx) if tp else None)
    if not tp:
        x = x + out
        return x + mlp_apply(lp, rms_norm(x, lp["ln2"]), cfg.mlp_kind), new_cache
    x = x + tp_residual(*out, pctx, False, x.dtype)
    y, form = tp_mlp(lp, TPInput(rms_norm(x, lp["ln2"]), pctx), cfg.mlp_kind, cfg.d_model,
                     cfg.d_ff, pctx, x.dtype)
    return x + tp_residual(y, form, pctx, False, x.dtype), new_cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------
def _run(params, cfg: ArchConfig, x: torch.Tensor, cache: dict | None = None, cache_pos=None,
         *, remat: bool = False, attn_impl: str = "flash", pctx=None):
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
                block = lambda lp_, x_: rec_block(lp_, cfg, x_, pctx=pctx)[0]  # noqa: E731
                x = T.remat_call(block, lp, x) if remat else block(lp, x)
            else:
                x, new = rec_block(lp, cfg, x, state=(cache["conv"][ri], cache["h"][ri]),
                                   pctx=pctx)
                cache["conv"][ri], cache["h"][ri] = new
            ri += 1
        else:
            lp = T.layer_params(params["attn"], ai)
            kvc = (cache["k"][ai], cache["v"][ai]) if cache is not None else None
            block = lambda lp_, x_: attn_block(lp_, cfg, x_, rope=rope, kv_cache=kvc,  # noqa: E731
                                               cache_pos=cache_pos, attn_impl=attn_impl,
                                               pctx=pctx)[0]
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


def forward(params, cfg: ArchConfig, tokens, *, pctx=None, **_) -> torch.Tensor:
    """Cache-less forward without gradients: float32 logits ``[B, S, V]``."""
    with torch.no_grad():
        x, _ = _run(params, cfg, T.embed_tokens(params, cfg, tokens, pctx=pctx), pctx=pctx)
        return T.unembed(params, cfg, x, pctx)


def loss_fn(params, cfg: ArchConfig, tokens, labels, *, remat: bool = True, pctx=None,
            **_) -> torch.Tensor:
    """Mean next-token cross entropy of the cache-less forward, differentiable:
    attention in the reference's torch ops, each block recomputed in the backward
    pass with ``remat``."""
    x, _ = _run(params, cfg, T.embed_tokens(params, cfg, tokens, pctx=pctx), remat=remat,
                attn_impl="reference", pctx=pctx)
    return cross_entropy(T.unembed(params, cfg, x, pctx), labels)


def prefill(params, cfg: ArchConfig, tokens, cache: dict, *, pctx=None, **_):
    """The prompt from position 0 into ``cache`` (over a model axis this rank's
    blocks of it, :func:`tp_state`); the last position's logits and the cache."""
    with torch.no_grad():
        x, cache = _run(params, cfg, T.embed_tokens(params, cfg, tokens, pctx=pctx), cache=cache,
                        cache_pos=0, pctx=pctx)
        return T.unembed(params, cfg, x[:, -1:], pctx), cache


def decode_step(params, cfg: ArchConfig, token, cache: dict, pos, *, pctx=None, **_):
    """One token a row at position ``pos`` (a scalar) -> ``[B, 1, V]`` logits."""
    with torch.no_grad():
        x, cache = _run(params, cfg, T.embed_tokens(params, cfg, token, pctx=pctx), cache=cache,
                        cache_pos=pos, pctx=pctx)
        return T.unembed(params, cfg, x, pctx), cache
