"""Decoder LM: init, the block stack, prefill and decode over a KV cache.

The decoder-LM subset of the JAX package's ``repro/models/transformer.py``
for the ``dense`` family (GQA attention with optional QK-norm, RoPE, a
SwiGLU/GeGLU/GELU MLP), with the same parameter tree, cache layouts and
tap sites. Block parameters are stacked on a leading ``[L, ...]`` axis as
in the JAX package; where it runs ``lax.scan`` over them this module runs
a Python loop over per-layer views (a float leaf's ``[i]``, a packed
leaf's :meth:`~repro_torch.kernels.ops.PackedWeight.layer`), so no layer's
weights are copied.

KV caches are dicts of ``[L, B, Smax, KV, hd]`` tensors in one of three
layouts (:func:`cache_layout` names them from the keys):

  * dense: ``{"k", "v"}`` in the model dtype;
  * dynamic int8 (``"quant"``): ``{"k", "v", "ks", "vs"}``, int8 codes with
    per-(token, head) float32 scales computed at write time;
  * static int8: ``{"k", "v", "k_scale", "v_scale"}``, int8 codes against
    per-(layer, head) scales calibrated offline
    (:func:`repro_torch.calib.runner.calibrate_kv_cache`).

Unlike the JAX package, which returns a new cache from every call, the
port writes the new entries into the cache tensors in place (a full-width
cache is gigabytes, and a copy per step would double it) and returns the
same dict. The paged layouts, the ``pctx`` multi-device context,
flash-decode, cross-attention, MoE and modality frontends are not ported
(ROADMAP.md, queue 1 items 6-8); inputs that select them raise
``NotImplementedError``.

Prefill attention (the non-decode, unwindowed, causal case) goes through
:func:`repro_torch.kernels.flash_attention.flash_attention`: the CUDA
kernel for tensors on the card, its plain version on the CPU. Queries and
the written key prefix ``[0, cache_pos + s)`` are padded to the kernel's
block; padded keys lie past every real query, so the causal mask hides
them. The decode branch stays :func:`~repro_torch.models.layers.attention_dot`
in torch ops, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models.layers import (
    apply_rope,
    attention_chunked,
    attention_dot,
    dense_init,
    matmul,
    mlp_apply,
    repeat_kv,
    rms_norm,
    rope_embed,
)

F32 = torch.float32

# KV length at/above which the JAX package switches to chunked attention;
# the port keeps it for the windowed and non-causal cases that do not go to
# the flash kernel.
CHUNKED_ATTN_THRESHOLD = 4096
ATTN_CHUNK = 1024
FLASH_BLOCK = 128  # the flash kernel's sequence block (callers pad to it)

_NOT_PORTED = "not ported to repro_torch yet; see ROADMAP.md (queue 1 items 6-8)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_block_params(
    cfg: ArchConfig, gen: torch.Generator, n_layers: int, *, cross: bool = False
) -> dict[str, torch.Tensor]:
    """Stacked parameters for ``n_layers`` transformer blocks (dense family), on ``gen``'s device.

    Each ``[L, in, out]`` leaf is drawn one layer slice at a time, so only
    one slice's float32 draw is alive besides the stack.
    """
    if cross:
        raise _not_ported("cross-attention (the enc-dec family)")
    if cfg.is_moe:
        raise _not_ported("the MoE family")
    d, hd, h, kv, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = cfg.dtype
    device = gen.device

    def stack(shape):
        out = torch.empty((n_layers, *shape), dtype=dt, device=device)
        for i in range(n_layers):
            out[i] = dense_init(gen, shape, dt)
        return out

    p = {
        "ln1": torch.zeros((n_layers, d), dtype=dt, device=device),
        "ln2": torch.zeros((n_layers, d), dtype=dt, device=device),
        "wq": stack((d, h * hd)),
        "wk": stack((d, kv * hd)),
        "wv": stack((d, kv * hd)),
        "wo": stack((h * hd, d)),
    }
    if cfg.qk_norm:
        p["qnorm"] = torch.zeros((n_layers, hd), dtype=dt, device=device)
        p["knorm"] = torch.zeros((n_layers, hd), dtype=dt, device=device)
    p["w1"] = stack((d, ff))
    p["w2"] = stack((ff, d))
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["w3"] = stack((d, ff))
    return p


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded decoder-LM parameters in the JAX package's tree, scales and dtype.

    ``dense_init``'s truncated-normal fan-in scales for the matrices, zeros
    for the norms (their ``1 + scale`` form makes that the identity). The
    draws come from a ``torch.Generator`` on ``device`` (default: the
    card), so the numbers differ from the JAX package's; the shapes, names
    and distributions are the same.
    """
    if cfg.family != "dense":
        raise _not_ported(f"the {cfg.family!r} family")
    if cfg.frontend_tokens:
        raise _not_ported("the modality frontend")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype),
        "blocks": init_block_params(cfg, gen, cfg.n_layers),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype)
    return p


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block parameters, as views (no copy)."""
    return {k: v.layer(i) if isinstance(v, PackedWeight) else v[i] for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Cache helpers
# ---------------------------------------------------------------------------
def _as_pos(pos):
    """A scalar position as a Python int, a per-row one as a ``[B]`` tensor."""
    if isinstance(pos, torch.Tensor):
        if pos.ndim == 0:
            return int(pos)
        if pos.ndim != 1:
            raise ValueError(f"cache positions are a scalar or a [B] vector; got {tuple(pos.shape)}")
        return pos.long()
    return int(pos)


def _cache_set(c: torch.Tensor, u: torch.Tensor, pos) -> torch.Tensor:
    """Write ``u[B, s, ...]`` into cache ``c[B, S, ...]`` at ``pos``, in place.

    A scalar ``pos`` writes one contiguous run at the same offset for every
    row (prefill, lockstep decode); a ``[B]`` vector writes row ``b``'s
    ``s`` tokens at ``pos[b] ..`` (continuous batching, speculative verify).
    """
    u = u.to(c.dtype)
    if not isinstance(pos, torch.Tensor):
        c[:, pos:pos + u.shape[1]] = u
        return c
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    cols = pos.to(c.device)[:, None] + torch.arange(u.shape[1], device=c.device)[None, :]
    c[rows, cols] = u
    return c


def _cache_q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over head_dim: ``x[B, S, KV, hd]``."""
    xf = x.to(F32)
    sf = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / sf), -127, 127).to(torch.int8)
    return q, sf


def _cache_dq(q: torch.Tensor, sf: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(F32) * sf).to(dtype)


def _static_q(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Int8 codes of ``x[B, S, KV, hd]`` against calibrated per-head scales ``[KV]``."""
    sf = scale[None, None, :, None].to(F32)
    return torch.clamp(torch.round(x.to(F32) / sf), -127, 127).to(torch.int8)


def _static_dq(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(F32) * scale[None, None, :, None].to(F32)).to(dtype)


def cache_layout(cache: dict) -> str:
    """Name a KV-cache dict's layout from its keys: ``"dense"``, ``"quant"``,
    ``"static"``, or the (not ported) ``"paged"`` / ``"paged_static"``."""
    if "pages" in cache:
        return "paged_static" if "k_scale" in cache else "paged"
    if "ks" in cache:
        return "quant"
    if "k_scale" in cache:
        return "static"
    return "dense"


def init_cache(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    dtype=None,
    quant: bool = False,
    kv_scales=None,
    *,
    device=None,
) -> dict[str, torch.Tensor]:
    """Dense per-slot-row KV cache ``[L, B, Smax, KV, hd]`` on ``device`` (default: the card).

    ``quant=True`` stores int8 entries with per-(token, head) scales
    computed at write time; ``kv_scales=(k_scale, v_scale)`` (each
    ``[L, KV]``) stores int8 codes against those calibrated scales. The two
    are exclusive.
    """
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_dec_layers or cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    if quant and kv_scales is not None:
        raise ValueError("quant=True (dynamic) and kv_scales (static) are exclusive")
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.as_tensor(k_scale, dtype=F32).to(device),
            "v_scale": torch.as_tensor(v_scale, dtype=F32).to(device),
        }
    if quant:
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=F32, device=device),
            "vs": torch.zeros(sshape, dtype=F32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------
def _flash_prefill(q, k, v, q_offset: int) -> torch.Tensor:
    """Causal attention of ``q[B, s, H, hd]`` over keys ``k/v[B, n, KV, hd]`` on the flash kernel.

    Queries sit at ``q_offset ..``; q and the keys are padded to the
    kernel's block along the sequence (padded keys lie past every real
    query, so the causal mask hides them; padded query rows are dropped).
    """
    s, n = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, heads, seq, hd] views
    pq, pk = (-s) % FLASH_BLOCK, (-n) % FLASH_BLOCK
    if pq:
        qt = F.pad(qt, (0, 0, 0, pq))
    if pk:
        kt, vt = F.pad(kt, (0, 0, 0, pk)), F.pad(vt, (0, 0, 0, pk))
    out = flash_attention(qt, kt, vt, causal=True, block_q=FLASH_BLOCK, block_k=FLASH_BLOCK,
                          q_offset=q_offset)
    return out[:, :, :s].transpose(1, 2)


def _attention(
    lp: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    rope,
    causal: bool,
    window: int = 0,
    kv_cache: tuple | None = None,
    kv_layout: str = "dense",
    cache_pos=None,
    prefix: str = "w",
    kv_override: torch.Tensor | None = None,
    pctx=None,
    acts: dict | None = None,
    tap_kv: bool = False,
) -> tuple[torch.Tensor, tuple | None]:
    """GQA attention, optionally reading and updating a KV cache (write before attend).

    ``kv_layout`` names the cache tuple: ``"dense"`` ``(ck, cv)``,
    ``"quant"`` ``(ck, cv, cks, cvs)``, ``"static"`` ``(ck, cv, ksc, vsc)``.
    ``acts`` records the attention mix entering the output projection
    under ``"attn_mix"``; ``tap_kv`` also records the post-RoPE k/v under
    ``"k_cache"``/``"v_cache"``.
    """
    if kv_override is not None or prefix != "w":
        raise _not_ported("cross-attention (kv_override)")
    if pctx is not None:
        raise _not_ported("the multi-device ParallelCtx (pctx)")
    if kv_layout not in ("dense", "quant", "static"):
        raise _not_ported(f"the {kv_layout!r} KV-cache layout")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, lp["wq"]).reshape(b, s, h, hd)
    k = matmul(x, lp["wk"]).reshape(b, s, kv, hd)
    v = matmul(x, lp["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["qnorm"])
        k = rms_norm(k, lp["knorm"])
    if rope is not None:
        cos_q, sin_q, cos_k, sin_k = rope
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_k, sin_k)
    if tap_kv and acts is not None:
        acts["k_cache"] = k
        acts["v_cache"] = v

    new_cache = None
    if kv_cache is not None:
        cache_pos = _as_pos(cache_pos)
        if kv_layout == "quant":
            ck, cv, cks, cvs = kv_cache
            kq, ksf = _cache_q(k)
            vq, vsf = _cache_q(v)
            for c, u in ((ck, kq), (cv, vq), (cks, ksf), (cvs, vsf)):
                _cache_set(c, u, cache_pos)
            new_cache = (ck, cv, cks, cvs)
            k, v = _cache_dq(ck, cks, x.dtype), _cache_dq(cv, cvs, x.dtype)
        elif kv_layout == "static":
            ck, cv, ksc, vsc = kv_cache
            _cache_set(ck, _static_q(k, ksc), cache_pos)
            _cache_set(cv, _static_q(v, vsc), cache_pos)
            new_cache = (ck, cv)
            k, v = _static_dq(ck, ksc, x.dtype), _static_dq(cv, vsc, x.dtype)
        else:
            ck, cv = kv_cache
            _cache_set(ck, k, cache_pos)
            _cache_set(cv, v, cache_pos)
            new_cache = (ck, cv)
            k, v = ck, cv

    q_offset = cache_pos if kv_cache is not None else 0
    # "decode": s queries per row at per-row depth (s == 1, or a [B] position
    # vector); prefill (a scalar position) takes the flash kernel.
    decode = kv_cache is not None and (s == 1 or isinstance(cache_pos, torch.Tensor))
    if decode:
        out = attention_dot(q, repeat_kv(k, h // kv), repeat_kv(v, h // kv), causal=causal,
                            window=window, q_offset=q_offset)
    elif causal and not window:
        n = q_offset + s  # the written key prefix
        out = _flash_prefill(q, k[:, :n], v[:, :n], q_offset)
    else:
        kf, vf = repeat_kv(k, h // kv), repeat_kv(v, h // kv)
        attend = attention_chunked if kf.shape[1] >= CHUNKED_ATTN_THRESHOLD else attention_dot
        extra = {"chunk": ATTN_CHUNK} if attend is attention_chunked else {}
        out = attend(q, kf, vf, causal=causal, window=window, q_offset=q_offset, **extra)
    mix = out.reshape(b, s, h * hd)
    if acts is not None:
        acts["attn_mix"] = mix
    return matmul(mix, lp["wo"]), new_cache


def block_apply(
    lp: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    rope,
    causal: bool,
    window: int = 0,
    kv_cache: tuple | None = None,
    kv_layout: str = "dense",
    cache_pos=None,
    enc_out: torch.Tensor | None = None,
    pctx=None,
    acts: dict | None = None,
    tap_kv: bool = False,
) -> tuple[torch.Tensor, tuple | None]:
    """Pre-norm transformer block: attention + MLP.

    ``acts`` records the inputs of the block's matmuls: ``"attn_in"``
    (post-ln1, feeds wq/wk/wv), ``"attn_mix"`` (feeds wo), ``"ffn_in"``
    (post-ln2, feeds w1/w3) and ``"ffn_hidden"`` (feeds w2).
    """
    if enc_out is not None:
        raise _not_ported("cross-attention (enc_out)")
    if cfg.is_moe:
        raise _not_ported("the MoE family")
    attn_in = rms_norm(x, lp["ln1"])
    if acts is not None:
        acts["attn_in"] = attn_in
    attn_out, new_cache = _attention(
        lp, cfg, attn_in, rope=rope, causal=causal, window=window, kv_cache=kv_cache,
        kv_layout=kv_layout, cache_pos=cache_pos, pctx=pctx, acts=acts, tap_kv=tap_kv,
    )
    x = x + attn_out
    ffn_in = rms_norm(x, lp["ln2"])
    if acts is not None:
        acts["ffn_in"] = ffn_in
    return x + mlp_apply(lp, ffn_in, cfg.mlp_kind, acts=acts), new_cache


# ---------------------------------------------------------------------------
# Stack (a loop over layers)
# ---------------------------------------------------------------------------
_CACHE_KEYS = {"dense": ("k", "v"), "quant": ("k", "v", "ks", "vs"),
               "static": ("k", "v", "k_scale", "v_scale")}


def stack_apply(
    blocks: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    positions: torch.Tensor | None = None,
    cache: dict | None = None,
    cache_pos=None,
    enc_out: torch.Tensor | None = None,
    pctx=None,
    collect: bool = False,
    tap_kv: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """Run the block stack over its layers.

    ``collect=True`` (cache-less forward only) returns, in the second slot,
    the stacked per-layer activations: ``"block_out"`` (``[L, B, S, D]``)
    plus each block's matmul inputs, and with ``tap_kv`` the post-RoPE
    ``"k_cache"``/``"v_cache"`` (``[L, B, S, KV, hd]``). With a cache the
    second slot is the cache dict, written in place.
    """
    if collect and cache is not None:
        raise ValueError("collect=True is for the cache-less forward")
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_embed(positions, cfg.hd, cfg.rope_theta)
    rope = (cos, sin, cos, sin)  # new keys share the query positions

    layout = "dense" if cache is None else cache_layout(cache)
    if layout not in _CACHE_KEYS:
        raise _not_ported(f"the {layout!r} KV-cache layout")
    ys: list[dict] = []
    for i in range(blocks["ln1"].shape[0]):
        lp = layer_params(blocks, i)
        if cache is not None:
            kvc = tuple(cache[key][i] for key in _CACHE_KEYS[layout])
            x, _ = block_apply(lp, cfg, x, rope=rope, causal=causal, window=window, kv_cache=kvc,
                               kv_layout=layout, cache_pos=cache_pos, enc_out=enc_out, pctx=pctx)
            continue
        acts: dict | None = {} if (collect or tap_kv) else None
        x, _ = block_apply(lp, cfg, x, rope=rope, causal=causal, window=window, enc_out=enc_out,
                           pctx=pctx, acts=acts, tap_kv=tap_kv)
        if collect:
            ys.append({"block_out": x, **acts})
    if cache is not None:
        return x, cache
    if not collect:
        return x, None
    return x, {name: torch.stack([y[name] for y in ys]) for name in ys[0]}


# ---------------------------------------------------------------------------
# Decoder LM public API
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ArchConfig, tokens: torch.Tensor, frontend=None) -> torch.Tensor:
    if frontend is not None:
        raise _not_ported("the modality frontend")
    return params["embed"][tokens.to(params["embed"].device).long()].to(cfg.dtype)


def unembed(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then float32 logits ``x @ head``.

    The JAX package multiplies the model-dtype operands with a float32
    result; here both operands go to float32 (exact for bfloat16 values)
    and the product runs in full float32 (no TF32).
    """
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    with full_f32():
        return torch.matmul(x.to(F32), head.to(x.dtype).to(F32))


def forward(params, cfg: ArchConfig, tokens, *, frontend=None, pctx=None, tap=None,
            tap_kv: bool = False) -> torch.Tensor:
    """Cache-less forward: logits ``[B, S, V]`` (float32).

    ``tap`` is the activation-tap hook of the calibration contract: sites
    ``"embed"``, ``"blocks"`` (stacked block outputs ``[L, B, S, D]``), the
    stacked matmul inputs ``"attn_in"``/``"attn_mix"``/``"ffn_in"``/
    ``"ffn_hidden"`` and ``"final"``; ``tap_kv=True`` adds the post-RoPE
    ``"k_cache"``/``"v_cache"`` sites (``[L, B, S, KV, hd]``).
    """
    with torch.no_grad():
        x = embed_tokens(params, cfg, tokens, frontend)
        if tap is not None:
            x = tap("embed", x)
        x, ys = stack_apply(params["blocks"], cfg, x, causal=True, window=cfg.window, pctx=pctx,
                            collect=tap is not None, tap_kv=tap_kv)
        if tap is not None:
            tap("blocks", ys.pop("block_out"))
            for site, act in ys.items():
                tap(site, act)
            x = tap("final", x)
        return unembed(params, cfg, x)


def prefill(params, cfg: ArchConfig, tokens, cache: dict, *, frontend=None, pctx=None):
    """Fill the cache with the prompt; return the last position's logits and the cache."""
    with torch.no_grad():
        x = embed_tokens(params, cfg, tokens, frontend)
        x, cache = stack_apply(params["blocks"], cfg, x, causal=True, window=cfg.window,
                               cache=cache, cache_pos=0, pctx=pctx)
        return unembed(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ArchConfig, token, cache: dict, pos, *, pctx=None):
    """One decode step: ``token [B, s]`` at position ``pos`` -> logits ``[B, s, V]``.

    ``pos`` is a scalar (every row at the same position) or a ``[B]``
    vector of per-row positions, each row's KV written at its own offset
    and its attention masked to its own past. ``s > 1`` places row ``b``'s
    tokens at ``pos[b] .. pos[b] + s - 1``, causal within the run.
    """
    with torch.no_grad():
        pos = _as_pos(pos)
        s = token.shape[1]
        dev = params["embed"].device
        ar = torch.arange(s, device=dev)
        if isinstance(pos, torch.Tensor):
            pos = pos.to(dev)
            positions = pos[:, None] + ar[None, :]
        else:
            positions = (pos + ar)[None, :]
        x = embed_tokens(params, cfg, token)
        x, cache = stack_apply(params["blocks"], cfg, x, causal=True, window=cfg.window,
                               positions=positions, cache=cache, cache_pos=pos, pctx=pctx)
        return unembed(params, cfg, x), cache
