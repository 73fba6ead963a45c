"""Mamba-2 (SSD, state-space duality): the ``ssm`` family.

The JAX package's ``repro/models/mamba2.py`` with the same parameter tree
and state. The sequence is split into chunks of ``Q`` tokens; inside a
chunk the ``[Q, Q]`` semiseparable block is a dense product, and the
state between chunks is carried by a loop over the chunks (where the JAX
package runs ``lax.scan``). A one-token recurrent step serves decode.

Layout: one scalar A per head, one B/C group shared across heads. Per
layer (stacked on a leading ``[L, ...]`` axis):

  in_proj  [d, 2*d_in + 2*state + nh]   (z | x | B | C | dt)
  conv_w   [cw, d_in + 2*state], conv_b  (depthwise causal conv)
  A_log, D, dt_bias [nh]                 (float32 in every model dtype)
  gnorm    [d_in]                        (gated RMSNorm)
  out_proj [d_in, d]

``in_proj`` and ``out_proj`` go through :func:`~repro_torch.models.layers.matmul`
(on the card the packed kernels, one layer's slice of the stack at a
time); the SSD's einsums, the conv and the gates are float32 torch ops,
as the JAX package leaves them to XLA, with TF32 off. The state is
``(conv [L, B, cw - 1, C], ssd [L, B, nh, hd, state])``; like the
transformer's KV cache it is written in place and returned.

Over a model axis of more than one rank (``pctx``) each rank holds its
blocks of the weights under the sharding rules and runs its SSD heads
(:func:`heads`): ``in_proj``'s flat column block cuts across the segments,
so its output is gathered whole and each rank takes its heads' z, x and dt
and every head's B and C (one group); the conv runs on the rank's block of
the channels (``conv_w``'s rule block) and its output is gathered (on every
channel on every rank where the axis does not divide them); the gated
RMSNorm sums its rows' float32 squares over the ranks; ``out_proj`` is
row-parallel on the heads' rows. The state holds the rank's conv channels
and SSD heads (:func:`tp_state`).

Einsum index legend: b batch, c chunk, t/s positions in a chunk, n heads,
d head_dim, m ssm_state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32, resolve_device
from repro_torch.models.layers import (
    TPInput,
    causal_conv,
    cross_entropy,
    dense_init,
    init_device,
    init_generator,
    local_kn,
    matmul,
    rms_norm,
    row_blocks,
    softplus,
    tp_active,
    tp_full,
    tp_matmul,
    tp_residual,
    tp_rms_norm,
    tp_take,
)
from repro_torch.runtime import collectives

F32 = torch.float32

SSD_CHUNK = 256


def dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """``(d_in, n_heads, head_dim, state)``."""
    d_in = cfg.expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_head_dim, cfg.ssm_state


def init_layer_stack(cfg: ArchConfig, gen: torch.Generator, n_layers: int) -> dict:
    """Stacked parameters of ``n_layers`` blocks on ``gen``'s device."""
    d = cfg.d_model
    d_in, nh, _, st = dims(cfg)
    conv_ch = d_in + 2 * st
    dt, device = cfg.dtype, init_device(gen)

    def stack(shape):
        out = torch.empty((n_layers, *shape), dtype=dt, device=device)
        if gen is None:
            return out
        for i in range(n_layers):
            out[i] = dense_init(gen, shape, dt)
        return out

    # dt_bias so that softplus(dt_bias) spans [1e-3, 1e-1] (the mamba2 default)
    u = torch.rand((n_layers, nh), generator=gen, dtype=F32, device=device)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "ln": torch.zeros((n_layers, d), dtype=dt, device=device),
        "in_proj": stack((d, 2 * d_in + 2 * st + nh)),
        "conv_w": stack((cfg.conv_width, conv_ch)),
        "conv_b": torch.zeros((n_layers, conv_ch), dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=F32, device=device))[None].repeat(
            n_layers, 1),
        "D": torch.ones((n_layers, nh), dtype=F32, device=device),
        "dt_bias": dt_bias,
        "gnorm": torch.zeros((n_layers, d_in), dtype=dt, device=device),
        "out_proj": stack((d_in, d)),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded parameters in the JAX package's tree, scales and dtypes, on ``device``
    (default: the card). The draws are a ``torch.Generator``'s, not ``jax.random``'s."""
    device = resolve_device(device)
    gen = init_generator(device, seed)
    p = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype),
        "blocks": init_layer_stack(cfg, gen, cfg.n_layers),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype)
    return p


def _ssd_chunked(xh, dt, A, Bm, Cm, h0=None):
    """Chunked SSD scan, in float32.

    ``xh [B, S, nh, hd]``, ``dt [B, S, nh]`` (after softplus), ``A [nh]``
    (negative), ``Bm``/``Cm [B, S, st]``. Returns ``(y [B, S, nh, hd],
    state [B, nh, hd, st])``.
    """
    b, s, nh, hd = xh.shape
    st = Bm.shape[-1]
    q = min(SSD_CHUNK, s)
    if s % q:
        raise ValueError(f"the SSD takes whole chunks: S={s} with chunk {q}")
    nc = s // q
    with full_f32():
        xc = xh.reshape(b, nc, q, nh, hd)
        dtc = dt.reshape(b, nc, q, nh)
        bc = Bm.reshape(b, nc, q, st)
        cc = Cm.reshape(b, nc, q, st)

        la = dtc * A  # per-step log decay [b, nc, q, nh]
        cum = torch.cumsum(la, dim=2)
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # l_t - l_s [b, nc, t, s, nh]
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
        # the reference masks exp(seg), which overflows above the diagonal once a
        # chunk's decay passes e^88 and then gives its gradient inf * 0 = NaN;
        # masking seg first gives the same values and a finite gradient
        decay = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                                      torch.full((), -math.inf, dtype=F32, device=xh.device)))

        # intra-chunk: Y[t] = sum_{s<=t} (C_t . B_s) decay(t, s) dt_s x_s
        cb = torch.einsum("bctm,bcsm->bcts", cc, bc)
        w_ts = cb[..., None] * decay  # [b, nc, t, s, nh]
        xdt = xc * dtc[..., None]  # [b, nc, s, nh, hd]
        y_intra = torch.einsum("bctsn,bcsnd->bctnd", w_ts, xdt)

        # chunk summary state: S_c = sum_s exp(l_Q - l_s) dt_s B_s (x) x_s
        tail = torch.exp(cum[:, :, -1:, :] - cum)  # [b, nc, q, nh]
        sc = torch.einsum("bcsnd,bcsm->bcndm", xdt * tail[..., None], bc)  # [b, nc, nh, hd, st]
        chunk_decay = torch.exp(cum[:, :, -1, :])  # [b, nc, nh]

        # inter-chunk: the state entering each chunk, carried over the chunks
        h = torch.zeros((b, nh, hd, st), dtype=F32, device=xh.device) if h0 is None else h0
        h_prevs = []
        for c in range(nc):
            h_prevs.append(h)
            h = h * chunk_decay[:, c, :, None, None] + sc[:, c]
        h_prev = torch.stack(h_prevs, dim=1)  # [b, nc, nh, hd, st]

        # inter-chunk output: Y[t] += exp(l_t) * C_t . h_prev
        y_inter = torch.einsum("bctm,bcndm->bctnd", cc, h_prev) * torch.exp(cum)[..., None]
        return (y_intra + y_inter).reshape(b, s, nh, hd), h


def init_state(cfg: ArchConfig, batch: int, *, device=None) -> tuple:
    """Decode-time state on ``device`` (default: the card): the conv window
    ``[L, B, cw - 1, C]`` in the model dtype and the SSD state
    ``[L, B, nh, hd, st]`` in float32."""
    device = resolve_device(device)
    d_in, nh, hd, st = dims(cfg)
    conv = torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, d_in + 2 * st),
                       dtype=cfg.dtype, device=device)
    ssd = torch.zeros((cfg.n_layers, batch, nh, hd, st), dtype=F32, device=device)
    return conv, ssd


def heads(cfg: ArchConfig, pctx=None) -> tuple[int, int]:
    """``[lo, hi)``: this rank's SSD heads, near-equal blocks in rank order over a
    model axis of more than one rank (every head without one)."""
    nh = dims(cfg)[1]
    if not tp_active(pctx):
        return 0, nh
    m, r = pctx.model_size, pctx.model_rank
    if nh < m:
        raise ValueError(f"{nh} SSD heads leave some of {m} model ranks without a head")
    return r * nh // m, (r + 1) * nh // m


def _conv_split(cfg: ArchConfig, pctx) -> bool:
    """Whether the conv's channels are split over the model axis: the rules shard
    ``conv_w``'s channel dim where it divides (``runtime.sharding.param_spec``)."""
    d_in, _, _, st = dims(cfg)
    return tp_active(pctx) and (d_in + 2 * st) % pctx.model_size == 0


def _in_proj(lp: dict, cfg: ArchConfig, x: torch.Tensor, pctx=None):
    """``(z, xbc, dt)``: the gate, the conv's input ``x | B | C`` and the raw dt.

    Over a model axis the projection's blocks (the rules' flat column block cuts
    across the segments) are gathered whole, and ``z`` and ``dt`` are this rank's
    heads' (:func:`heads`); ``xbc`` is whole. Each rank's gradient of the
    projection is its share's (its heads, its conv channels or part of every
    channel's), summed over the ranks.
    """
    d_in, nh, hd, st = dims(cfg)
    n = 2 * d_in + 2 * st + nh
    y, form = tp_matmul(TPInput(rms_norm(x, lp["ln"]), pctx), lp["in_proj"], cfg.d_model, n,
                        pctx)
    proj = tp_take(tp_full(y, form, pctx, x.dtype), -1, 0, n, pctx)
    lo, hi = heads(cfg, pctx)
    return (proj[..., lo * hd:hi * hd], proj[..., d_in:2 * d_in + 2 * st],
            proj[..., n - nh + lo:n - nh + hi])


def _conv(lp: dict, cfg: ArchConfig, xbc: torch.Tensor, pctx=None, left=None):
    """``(conv, window)``: the depthwise causal conv of ``xbc`` (whole) after the
    cached window ``left``, and the conv window to keep (the last ``cw - 1``
    inputs). Where the rules split the channels (:func:`_conv_split`) this rank
    convolves its block of them, keeps their window, and the outputs are gathered
    (their gradient summed first: each rank's heads read part of them); otherwise
    every rank convolves every channel with the whole weights, whose gradients
    are summed over the ranks."""
    w, b = lp["conv_w"], lp["conv_b"]
    split = _conv_split(cfg, pctx)
    if split:
        lo, n = pctx.model_rank * w.shape[-1], w.shape[-1]
        xbc, b = xbc[..., lo:lo + n], tp_take(b, -1, lo, lo + n, pctx)
    else:
        w, b = (tp_take(t, -1, 0, t.shape[-1], pctx) for t in (w, b))
    ctx = xbc if left is None else torch.cat([left, xbc], dim=1)
    y = causal_conv(xbc, w, b, left=left)
    if split:
        y = collectives.gather_from_model(y, -1, pctx.model_group)
        y = tp_take(y, -1, 0, y.shape[-1], pctx)
    return y, ctx[:, -(cfg.conv_width - 1):]


def _ssd_inputs(lp: dict, cfg: ArchConfig, xbc: torch.Tensor, dt: torch.Tensor, pctx=None):
    """``(xh, dt, A, B, C)`` in float32 from the conv's output and the raw dt: this
    rank's heads (:func:`heads`) over a model axis, with every head's B and C."""
    d_in, nh, hd, st = dims(cfg)
    lo, hi = heads(cfg, pctx)
    xbc = F.silu(xbc)
    dt_bias, a_log = (tp_take(lp[k], -1, lo, hi, pctx) for k in ("dt_bias", "A_log"))
    xs, bm, cm = xbc[..., lo * hd:hi * hd], xbc[..., d_in:d_in + st], xbc[..., d_in + st:]
    b, s, _ = xs.shape
    xh = xs.reshape(b, s, hi - lo, hd).to(F32)
    dt = softplus(dt.to(F32) + dt_bias[None, None])
    return xh, dt, -torch.exp(a_log), bm.to(F32), cm.to(F32)


def _out(lp: dict, cfg: ArchConfig, res: torch.Tensor, y, xh, z, pctx=None) -> torch.Tensor:
    """The skip ``D``, the gated RMSNorm, ``out_proj`` and the residual. Over a model
    axis on this rank's heads: the norm's sums of squares summed over the ranks,
    ``out_proj`` row-parallel where its rule rows are the heads' (else on the
    gathered heads)."""
    b, s = res.shape[:2]
    d_in, nh, hd, _ = dims(cfg)
    lo, hi = heads(cfg, pctx)
    y = y + xh * tp_take(lp["D"], -1, lo, hi, pctx)[None, None, :, None]
    y = y.reshape(b, s, -1).to(res.dtype)
    y = tp_rms_norm(y * F.silu(z.to(F32)).to(res.dtype),
                    tp_take(lp["gnorm"], -1, lo * hd, hi * hd, pctx), d_in, pctx)
    w = lp["out_proj"]
    if hi - lo != nh:
        m = pctx.model_size
        sizes = [((r + 1) * nh // m - r * nh // m) * hd for r in range(m)]
        if local_kn(w)[0] != d_in and row_blocks(w, d_in, m) == sizes:
            return res + tp_residual(matmul(y, w, f32=True), "partial", pctx, False, res.dtype)
        y = collectives.gather_from_model(y, -1, pctx.model_group, sizes)
    out, form = tp_matmul(TPInput(y, pctx), w, d_in, cfg.d_model, pctx)
    return res + tp_residual(out, form, pctx, False, res.dtype)


def block_apply(lp: dict, cfg: ArchConfig, x: torch.Tensor, state: tuple | None = None,
                pctx=None):
    """One mamba2 block. ``state = (conv_cache [B, cw-1, C], h0 [B, nh, hd, st])``
    runs the one-token decode step and returns ``(out, (new_conv, h_new))``;
    ``None`` runs the chunked parallel form and returns ``(out, None)``. Over a
    model axis the state holds this rank's conv channels (:func:`_conv`) and
    heads (:func:`heads`)."""
    out, new_state = _block(lp, cfg, x, state, pctx)
    return out, None if state is None else new_state


def _block(lp: dict, cfg: ArchConfig, x: torch.Tensor, state: tuple | None, pctx):
    """:func:`block_apply`, whose parallel form also returns the conv window and
    SSD state that a prefill leaves."""
    z, xbc, dt = _in_proj(lp, cfg, x, pctx)
    if state is None:
        xbc, new_conv = _conv(lp, cfg, xbc, pctx)
    else:
        conv_cache, h0 = state
        xbc, new_conv = _conv(lp, cfg, xbc, pctx, left=conv_cache)
    xh, dt, A, bm, cm = _ssd_inputs(lp, cfg, xbc, dt, pctx)
    if state is None:
        y, h_new = _ssd_chunked(xh, dt, A, bm, cm)
    else:
        dec = torch.exp(dt[:, 0, :] * A[None])  # [b, nh]
        upd = (xh[:, 0] * dt[:, 0, :, None])[..., None] * bm[:, 0, None, None, :]
        h_new = h0 * dec[..., None, None] + upd
        y = (h_new * cm[:, 0, None, None, :]).sum(-1)[:, None]
    return _out(lp, cfg, x, y, xh, z, pctx), (new_conv, h_new)


def tp_state(state: tuple, cfg: ArchConfig, pctx) -> tuple:
    """A whole ``(conv, ssd)`` state's layout on this rank over a model axis: the
    conv windows' channel block where the rules split ``conv_w`` (else whole), and
    the SSD state's heads (:func:`heads`). The reference's ``cache_spec`` shards the
    SSD state's widest trailing dim (``state``) instead; each rank here updates
    whole heads."""
    conv, ssd = state
    if _conv_split(cfg, pctx):
        n = conv.shape[-1] // pctx.model_size
        conv = conv.narrow(-1, pctx.model_rank * n, n)
    lo, hi = heads(cfg, pctx)
    return conv.contiguous(), ssd.narrow(2, lo, hi - lo).contiguous()


def _layers(params):
    from repro_torch.models.transformer import layer_params

    blocks = params["blocks"]
    return [layer_params(blocks, i) for i in range(blocks["ln"].shape[0])]


def _logits(params, cfg: ArchConfig, tokens, remat: bool = False, pctx=None) -> torch.Tensor:
    from repro_torch.models.transformer import embed_tokens, remat_call, unembed

    def block(lp, x):
        return _block(lp, cfg, x, None, pctx)[0]

    x = embed_tokens(params, cfg, tokens, pctx=pctx)
    for lp in _layers(params):
        x = remat_call(block, lp, x) if remat else block(lp, x)
    return unembed(params, cfg, x, pctx)


def forward(params, cfg: ArchConfig, tokens, *, pctx=None, **_) -> torch.Tensor:
    """Cache-less forward without gradients: float32 logits ``[B, S, V]``."""
    with torch.no_grad():
        return _logits(params, cfg, tokens, pctx=pctx)


def loss_fn(params, cfg: ArchConfig, tokens, labels, *, remat: bool = True, pctx=None,
            **_) -> torch.Tensor:
    """Mean next-token cross entropy of the cache-less forward, differentiable (the
    chunked SSD writes no tensor in place); ``remat`` recomputes each block in the
    backward pass."""
    return cross_entropy(_logits(params, cfg, tokens, remat, pctx), labels)


def prefill(params, cfg: ArchConfig, tokens, state, *, pctx=None, **_):
    """The chunked parallel forward that also leaves each layer's conv window
    and final SSD state in ``state`` (written in place; over a model axis this
    rank's blocks of it, :func:`tp_state`) for decode; returns the last
    position's logits and the state."""
    from repro_torch.models.transformer import embed_tokens, unembed

    conv, ssd = state
    with torch.no_grad():
        x = embed_tokens(params, cfg, tokens, pctx=pctx)
        for i, lp in enumerate(_layers(params)):
            x, (conv[i], ssd[i]) = _block(lp, cfg, x, None, pctx)
        return unembed(params, cfg, x[:, -1:], pctx), state


def decode_step(params, cfg: ArchConfig, token, state, pos=None, *, pctx=None, **_):
    """One token a row against the recurrent state (updated in place); ``pos`` is
    not used (the state carries the position). Returns ``[B, 1, V]`` logits."""
    from repro_torch.models.transformer import embed_tokens, unembed

    conv, ssd = state
    with torch.no_grad():
        x = embed_tokens(params, cfg, token, pctx=pctx)
        for i, lp in enumerate(_layers(params)):
            x, (conv[i], ssd[i]) = _block(lp, cfg, x, (conv[i], ssd[i]), pctx)
        return unembed(params, cfg, x, pctx), state
