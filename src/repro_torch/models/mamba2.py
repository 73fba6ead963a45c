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
    causal_conv,
    cross_entropy,
    dense_init,
    matmul,
    rms_norm,
    softplus,
)

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
    dt, device = cfg.dtype, gen.device

    def stack(shape):
        out = torch.empty((n_layers, *shape), dtype=dt, device=device)
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
    gen = torch.Generator(device=device).manual_seed(seed)
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
        decay = torch.where(mask[None, None, :, :, None], torch.exp(seg),
                            torch.zeros((), dtype=F32, device=xh.device))

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


def _in_proj(lp: dict, cfg: ArchConfig, x: torch.Tensor):
    """``(z, xbc, dt)``: the gate, the conv's input ``x | B | C`` and the raw dt."""
    d_in, nh, _, st = dims(cfg)
    proj = matmul(rms_norm(x, lp["ln"]), lp["in_proj"])
    z, xs, bm, cm, dt = torch.split(proj, [d_in, d_in, st, st, nh], dim=-1)
    return z, torch.cat([xs, bm, cm], dim=-1), dt


def _ssd_inputs(lp: dict, cfg: ArchConfig, xbc: torch.Tensor, dt: torch.Tensor):
    """``(xh, dt, A, B, C)`` in float32 from the conv's output and the raw dt."""
    d_in, nh, hd, st = dims(cfg)
    xbc = F.silu(xbc)
    xs, bm, cm = torch.split(xbc, [d_in, st, st], dim=-1)
    b, s, _ = xs.shape
    xh = xs.reshape(b, s, nh, hd).to(F32)
    dt = softplus(dt.to(F32) + lp["dt_bias"][None, None])
    return xh, dt, -torch.exp(lp["A_log"]), bm.to(F32), cm.to(F32)


def _out(lp: dict, cfg: ArchConfig, res: torch.Tensor, y, xh, z) -> torch.Tensor:
    """The skip ``D``, the gated RMSNorm, ``out_proj`` and the residual."""
    b, s = res.shape[:2]
    y = y + xh * lp["D"][None, None, :, None]
    y = y.reshape(b, s, -1).to(res.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(res.dtype), lp["gnorm"])
    return res + matmul(y, lp["out_proj"])


def block_apply(lp: dict, cfg: ArchConfig, x: torch.Tensor, state: tuple | None = None):
    """One mamba2 block. ``state = (conv_cache [B, cw-1, C], h0 [B, nh, hd, st])``
    runs the one-token decode step and returns ``(out, (new_conv, h_new))``;
    ``None`` runs the chunked parallel form and returns ``(out, None)``."""
    z, xbc, dt = _in_proj(lp, cfg, x)
    new_state = None
    if state is None:
        xbc = causal_conv(xbc, lp["conv_w"], lp["conv_b"])
    else:
        conv_cache, h0 = state
        new_conv = torch.cat([conv_cache, xbc], dim=1)[:, -(cfg.conv_width - 1):]
        xbc = causal_conv(xbc, lp["conv_w"], lp["conv_b"], left=conv_cache)
    xh, dt, A, bm, cm = _ssd_inputs(lp, cfg, xbc, dt)
    if state is None:
        y, _ = _ssd_chunked(xh, dt, A, bm, cm)
    else:
        dec = torch.exp(dt[:, 0, :] * A[None])  # [b, nh]
        upd = (xh[:, 0] * dt[:, 0, :, None])[..., None] * bm[:, 0, None, None, :]
        h_new = h0 * dec[..., None, None] + upd
        y = (h_new * cm[:, 0, None, None, :]).sum(-1)[:, None]
        new_state = (new_conv, h_new)
    return _out(lp, cfg, x, y, xh, z), new_state


def _layers(params):
    from repro_torch.models.transformer import layer_params

    blocks = params["blocks"]
    return [layer_params(blocks, i) for i in range(blocks["ln"].shape[0])]


def _logits(params, cfg: ArchConfig, tokens, remat: bool = False) -> torch.Tensor:
    from repro_torch.models.transformer import embed_tokens, remat_call, unembed

    def block(lp, x):
        return block_apply(lp, cfg, x)[0]

    x = embed_tokens(params, cfg, tokens)
    for lp in _layers(params):
        x = remat_call(block, lp, x) if remat else block(lp, x)
    return unembed(params, cfg, x)


def forward(params, cfg: ArchConfig, tokens, **_) -> torch.Tensor:
    """Cache-less forward without gradients: float32 logits ``[B, S, V]``."""
    with torch.no_grad():
        return _logits(params, cfg, tokens)


def loss_fn(params, cfg: ArchConfig, tokens, labels, *, remat: bool = True, **_) -> torch.Tensor:
    """Mean next-token cross entropy of the cache-less forward, differentiable (the
    chunked SSD writes no tensor in place); ``remat`` recomputes each block in the
    backward pass."""
    return cross_entropy(_logits(params, cfg, tokens, remat), labels)


def prefill(params, cfg: ArchConfig, tokens, state, **_):
    """The chunked parallel forward that also leaves each layer's conv window
    and final SSD state in ``state`` (written in place) for decode; returns the
    last position's logits and the state."""
    from repro_torch.models.transformer import embed_tokens, unembed

    conv, ssd = state
    with torch.no_grad():
        x = embed_tokens(params, cfg, tokens)
        for i, lp in enumerate(_layers(params)):
            z, xbc, dt = _in_proj(lp, cfg, x)
            conv[i] = xbc[:, -(cfg.conv_width - 1):]
            xh, dtv, A, bm, cm = _ssd_inputs(lp, cfg, causal_conv(xbc, lp["conv_w"],
                                                                    lp["conv_b"]), dt)
            y, ssd[i] = _ssd_chunked(xh, dtv, A, bm, cm)
            x = _out(lp, cfg, x, y, xh, z)
        return unembed(params, cfg, x[:, -1:]), state


def decode_step(params, cfg: ArchConfig, token, state, pos=None, **_):
    """One token a row against the recurrent state (updated in place); ``pos`` is
    not used (the state carries the position). Returns ``[B, 1, V]`` logits."""
    from repro_torch.models.transformer import embed_tokens, unembed

    conv, ssd = state
    with torch.no_grad():
        x = embed_tokens(params, cfg, token)
        for i, lp in enumerate(_layers(params)):
            x, (conv[i], ssd[i]) = block_apply(lp, cfg, x, state=(conv[i], ssd[i]))
        return unembed(params, cfg, x), state
