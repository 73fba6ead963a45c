"""Decoder LM and the generic block stack: init, prefill and decode over a KV cache.

The JAX package's ``repro/models/transformer.py`` for the ``dense``,
``moe`` and ``vlm`` families (GQA attention with optional QK-norm, RoPE,
a SwiGLU/GeGLU/GELU MLP or the MoE FFN of :mod:`repro_torch.models.moe`,
the stub modality frontend's projection), with the same parameter tree,
cache layouts and tap sites; its blocks also serve the enc-dec model
(:mod:`repro_torch.models.encdec`: a non-causal encoder stack, and a
decoder stack whose blocks add cross-attention over the encoder output,
``xq``/``xk``/``xv``/``xo`` after ``ln_x``, without RoPE) and the hybrid's
attention layers (:mod:`repro_torch.models.rglru`). Block
parameters are stacked on a leading ``[L, ...]`` axis as
in the JAX package; where it runs ``lax.scan`` over them this module runs
a Python loop over per-layer views (a float leaf's ``[i]``, a packed
leaf's :meth:`~repro_torch.kernels.ops.PackedWeight.layer`), so no layer's
weights are copied.

KV caches are dicts in one of five layouts (:func:`cache_layout` names
them from the keys):

  * dense: ``{"k", "v"}`` ``[L, B, Smax, KV, hd]`` in the model dtype;
  * dynamic int8 (``"quant"``): ``{"k", "v", "ks", "vs"}``, int8 codes with
    per-(token, head) float32 scales computed at write time;
  * static int8: ``{"k", "v", "k_scale", "v_scale"}``, int8 codes against
    per-(layer, head) scales calibrated offline
    (:func:`repro_torch.calib.runner.calibrate_kv_cache`);
  * paged (``"paged"``, ``"paged_static"``): a physical page pool
    ``{"k", "v"}`` ``[L, n_pages, page, KV, hd]`` (static int8 codes with
    ``"k_scale"``/``"v_scale"``) and a per-slot page table
    ``"pages" [B, Pmax]`` (:func:`init_paged_cache`; the serve engine's
    :class:`~repro_torch.serve.paging.PageTable` owns it).

Unlike the JAX package, which returns a new cache from every call, the
port writes the new entries into the cache tensors in place (a full-width
cache is gigabytes, and a copy per step would double it) and returns the
same dict. A ``vlm`` model's frontend is the reference's stub: the caller
hands over precomputed patch embeddings ``[B, F, D]``, which
``frontend_proj`` maps and prepends to the token embeddings. Not ported:
the ``pctx`` multi-device context and flash-decode (ROADMAP.md, queue 1
item 4); inputs that select them raise ``NotImplementedError``.

Prefill-shaped attention without a window goes through
:func:`repro_torch.kernels.flash_attention.flash_attention`, the CUDA
kernel for tensors on the card, its plain version on the CPU: causal
(the written key prefix ``[0, cache_pos + s)``), and non-causal with more
than one query a row (the encoder's self-attention, cross-attention at
prefill). Queries are padded to the kernel's block and the padded rows
dropped; keys go in at their true count, which the kernel masks
(``kpos >= Sk``), so no zero key ever enters a non-causal softmax. Decode
(one query a row against a cache, or a cross-attention step) and windowed
attention stay :func:`~repro_torch.models.layers.attention_dot` in torch
ops, as the JAX package leaves them to XLA.

Training (:func:`loss_fn`) differentiates the cache-less forward. The
kernels have no backward (the JAX package's have none either), so the
loss forward runs with ``attn_impl="reference"``: prefill-shaped attention
as the JAX package computes it in training, ``attention_dot`` or, from
``CHUNKED_ATTN_THRESHOLD`` keys, ``attention_chunked``, in torch ops.
The caller picks ``attn_impl``; nothing falls back from the kernel. With
``remat`` each block's activations are recomputed in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of the
scan body).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_rope,
    attention_chunked,
    attention_dot,
    cross_entropy,
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
# Prefill-shaped attention: on the flash kernel, or the reference's torch ops
# (the training forward, which the kernel's lack of a backward rules out).
ATTN_IMPLS = ("flash", "reference")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md (queue 1 item {item})")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_block_params(
    cfg: ArchConfig, gen: torch.Generator, n_layers: int, *, cross: bool = False
) -> dict[str, torch.Tensor]:
    """Stacked parameters for ``n_layers`` transformer blocks, on ``gen``'s device.

    Each ``[L, in, out]`` leaf is drawn one layer slice at a time, and an
    MoE expert stack ``[L, E, in, out]`` one ``(layer, expert)`` slice at a
    time, so only one slice's float32 draw is alive besides the stack.
    """
    d, hd, h, kv, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = cfg.dtype
    device = gen.device

    def stack(shape, scale=1.0):
        out = torch.empty((n_layers, *shape), dtype=dt, device=device)
        for i in range(n_layers):
            if len(shape) == 3:
                for j in range(shape[0]):
                    out[i, j] = dense_init(gen, shape[1:], dt, scale)
            else:
                out[i] = dense_init(gen, shape, dt, scale)
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
    if cross:
        p["ln_x"] = torch.zeros((n_layers, d), dtype=dt, device=device)
        p["xq"] = stack((d, h * hd))
        p["xk"] = stack((d, kv * hd))
        p["xv"] = stack((d, kv * hd))
        p["xo"] = stack((h * hd, d))
    if cfg.is_moe:
        e = cfg.n_experts
        p["router"] = stack((d, e))
        # The reference draws each layer's [E, in, out] stack with dense_init,
        # whose fan-in is the first dim: E. A slice's draw at fan-in `in`
        # takes scale sqrt(in / E) for the same std, 1 / sqrt(E).
        p["we1"] = stack((e, d, ff), math.sqrt(d / e))
        p["we3"] = stack((e, d, ff), math.sqrt(d / e))
        p["we2"] = stack((e, ff, d), math.sqrt(ff / e))
    else:
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
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the {cfg.family!r} family has its own parameter tree: "
                         "use repro_torch.models.get_model(cfg).init_params")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype),
        "blocks": init_block_params(cfg, gen, cfg.n_layers),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype)
    if cfg.frontend_tokens:
        # the stub modality frontend: callers supply precomputed patch embeddings
        p["frontend_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), cfg.dtype)
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
    ``"static"``, ``"paged"`` or ``"paged_static"``."""
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


def init_paged_cache(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    *,
    page_size: int,
    n_pages: int | None = None,
    kv_scales=None,
    dtype=None,
    device=None,
) -> dict[str, torch.Tensor]:
    """Paged KV cache on ``device`` (default: the card): a shared physical
    page pool plus a per-slot page table.

    ``k``/``v`` are ``[L, n_pages, page_size, KV, hd]``: int8 codes when
    ``kv_scales`` (calibrated per-(layer, head) scales, ``[L, KV]`` each) is
    given, else ``dtype``. ``pages [batch, Pmax]`` maps each slot's logical
    page ``p`` (positions ``p * page_size ..``) to a physical page; slots
    admitted with a matching prompt prefix point at the same physical pages
    (:class:`repro_torch.serve.paging.PageTable` owns the refcounts).
    ``n_pages`` defaults to ``batch * Pmax + batch``: every slot fully
    private plus one scratch page per slot, where a free slot's ride-along
    writes land.
    """
    page_size = int(page_size)
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    device = resolve_device(device)
    n_layers = cfg.n_dec_layers or cfg.n_layers
    pmax = -(-max_len // page_size)
    if n_pages is None:
        n_pages = batch * pmax + batch
    shape = (n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    store_dt = torch.int8 if kv_scales is not None else (dtype or cfg.dtype)
    cache = {
        "k": torch.zeros(shape, dtype=store_dt, device=device),
        "v": torch.zeros(shape, dtype=store_dt, device=device),
        "pages": torch.zeros((batch, pmax), dtype=torch.int64, device=device),
    }
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        cache["k_scale"] = torch.as_tensor(k_scale, dtype=F32).to(device)
        cache["v_scale"] = torch.as_tensor(v_scale, dtype=F32).to(device)
    return cache


def _cache_set_paged(c: torch.Tensor, u: torch.Tensor, pos, pages: torch.Tensor) -> torch.Tensor:
    """Write ``u[B, s, KV, hd]`` into the page pool ``c[P, page, KV, hd]``
    through the rows' page table ``pages[B, Pmax]``, in place.

    Row ``b``'s token at logical position ``p`` lands in physical page
    ``pages[b, p // page]`` at offset ``p % page``. Distinct rows never
    write the same physical page: shared pages hold only prompt-prefix
    positions below every sharer's writes, and each free slot's row points
    at its own scratch page.
    """
    b, s = u.shape[0], u.shape[1]
    page = c.shape[1]
    ar = torch.arange(s, device=c.device)
    if isinstance(pos, torch.Tensor):
        positions = pos.to(c.device)[:, None] + ar[None, :]
    else:
        positions = (pos + ar)[None, :].expand(b, s)
    pidx = torch.gather(pages, 1, positions // page)  # [B, s]
    c[pidx, positions % page] = u.to(c.dtype)
    return c


def _paged_view(c: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """The rows' logical dense views gathered out of the page pool:
    ``c[P, page, KV, hd]`` + ``pages[B, Pmax]`` -> ``[B, Pmax * page, KV, hd]``.

    Logical position ``p`` of row ``b`` is element ``p`` of the view, so the
    mask-past-pos read contract is the dense layout's.
    """
    v = c[pages]  # [B, Pmax, page, KV, hd]
    return v.reshape(v.shape[0], v.shape[1] * v.shape[2], *v.shape[3:])


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------
def _flash_prefill(q, k, v, q_offset: int, causal: bool = True) -> torch.Tensor:
    """Attention of ``q[B, s, H, hd]`` over keys ``k/v[B, n, KV, hd]`` on the flash kernel.

    Queries sit at ``q_offset ..`` (the causal mask's positions). q is
    padded to the kernel's block along the sequence and the padded rows
    dropped; the keys go in at their true count ``n``, which the kernel
    masks, so a non-causal softmax sees no padding.
    """
    s = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, heads, seq, hd] views
    pq = (-s) % FLASH_BLOCK
    if pq:
        qt = F.pad(qt, (0, 0, 0, pq))
    out = flash_attention(qt, kt, vt, causal=causal, block_q=FLASH_BLOCK, block_k=FLASH_BLOCK,
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
    attn_impl: str = "flash",
) -> tuple[torch.Tensor, tuple | None]:
    """GQA attention, optionally reading and updating a KV cache (write before attend).

    ``kv_layout`` names the cache tuple: ``"dense"`` ``(ck, cv)``,
    ``"quant"`` ``(ck, cv, cks, cvs)``, ``"static"`` ``(ck, cv, ksc, vsc)``,
    ``"paged"`` ``(ck, cv, pages)`` and ``"paged_static"``
    ``(ck, cv, pages, ksc, vsc)`` (a shared pool ``ck[P, page, KV, hd]``
    addressed through the rows' page table). A paged cache's read is the
    gathered logical view on the plain attention path, as in the JAX
    package, for prefill runs too.
    ``prefix="x"`` with ``kv_override`` (the encoder output ``[B, S_enc, D]``)
    is cross-attention: ``xq`` on ``x``, ``xk``/``xv`` on the encoder output,
    no RoPE, no QK-norm.
    ``acts`` records the attention mix entering the output projection
    under ``"attn_mix"``; ``tap_kv`` also records the post-RoPE k/v under
    ``"k_cache"``/``"v_cache"``. ``attn_impl`` (:data:`ATTN_IMPLS`) picks
    where prefill-shaped attention runs: ``"flash"`` on the kernel,
    ``"reference"`` in the JAX package's torch ops (the training forward).
    """
    if pctx is not None:
        raise _not_ported("the multi-device ParallelCtx (pctx)", 4)
    if kv_layout not in _CACHE_KEYS:
        raise ValueError(f"unknown KV-cache layout {kv_layout!r}")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kv_src = x if kv_override is None else kv_override
    q = matmul(x, lp[prefix + "q"]).reshape(b, s, h, hd)
    k = matmul(kv_src, lp[prefix + "k"]).reshape(b, kv_src.shape[1], kv, hd)
    v = matmul(kv_src, lp[prefix + "v"]).reshape(b, kv_src.shape[1], kv, hd)
    if cfg.qk_norm and prefix == "w":
        q = rms_norm(q, lp["qnorm"])
        k = rms_norm(k, lp["knorm"])
    if rope is not None and kv_override is None:
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
        elif kv_layout in ("paged", "paged_static"):
            # Write this step's k/v through the page table, then gather the
            # rows' logical views for the read. Shared prefix pages are never
            # written: every write lands at or past the row's own prompt length.
            if kv_layout == "paged_static":
                ck, cv, pages, ksc, vsc = kv_cache
                kq, vq = _static_q(k, ksc), _static_q(v, vsc)
            else:
                ck, cv, pages = kv_cache
                kq, vq = k, v
            _cache_set_paged(ck, kq, cache_pos, pages)
            _cache_set_paged(cv, vq, cache_pos, pages)
            new_cache = (ck, cv)
            k, v = _paged_view(ck, pages), _paged_view(cv, pages)
            if kv_layout == "paged_static":
                k, v = _static_dq(k, ksc, x.dtype), _static_dq(v, vsc, x.dtype)
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
    # vector); prefill (a scalar position) takes the flash kernel, causal or,
    # with more than one query a row, not.
    decode = kv_cache is not None and (s == 1 or isinstance(cache_pos, torch.Tensor)
                                       or kv_layout.startswith("paged"))
    flash = attn_impl == "flash" and not window
    if decode:
        out = attention_dot(q, repeat_kv(k, h // kv), repeat_kv(v, h // kv), causal=causal,
                            window=window, q_offset=q_offset)
    elif flash and causal:
        n = q_offset + s  # the written key prefix
        out = _flash_prefill(q, k[:, :n], v[:, :n], q_offset)
    elif flash and s > 1:
        out = _flash_prefill(q, k, v, 0, causal=False)
    else:
        kf, vf = repeat_kv(k, h // kv), repeat_kv(v, h // kv)
        attend = attention_chunked if kf.shape[1] >= CHUNKED_ATTN_THRESHOLD else attention_dot
        extra = {"chunk": ATTN_CHUNK} if attend is attention_chunked else {}
        out = attend(q, kf, vf, causal=causal, window=window, q_offset=q_offset, **extra)
    mix = out.reshape(b, s, h * hd)
    if acts is not None:
        acts["attn_mix"] = mix
    return matmul(mix, lp[prefix + "o"]), new_cache


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
    attn_impl: str = "flash",
) -> tuple[torch.Tensor, tuple | None]:
    """Pre-norm transformer block: attention, cross-attention over ``enc_out``
    (when given; the block then holds ``ln_x`` and ``xq``/``xk``/``xv``/``xo``),
    then the MLP or MoE. ``attn_impl`` as in :func:`_attention`, for both.

    ``acts`` records the inputs of the block's matmuls: ``"attn_in"``
    (post-ln1, feeds wq/wk/wv), ``"attn_mix"`` (feeds wo), ``"ffn_in"``
    (post-ln2, feeds w1/w3 or the router and experts) and ``"ffn_hidden"``
    (feeds w2; the dense MLP only).
    """
    attn_in = rms_norm(x, lp["ln1"])
    if acts is not None:
        acts["attn_in"] = attn_in
    attn_out, new_cache = _attention(
        lp, cfg, attn_in, rope=rope, causal=causal, window=window, kv_cache=kv_cache,
        kv_layout=kv_layout, cache_pos=cache_pos, pctx=pctx, acts=acts, tap_kv=tap_kv,
        attn_impl=attn_impl,
    )
    x = x + attn_out
    if enc_out is not None:
        xa_out, _ = _attention(lp, cfg, rms_norm(x, lp["ln_x"]), rope=None, causal=False,
                               prefix="x", kv_override=enc_out, attn_impl=attn_impl)
        x = x + xa_out
    ffn_in = rms_norm(x, lp["ln2"])
    if acts is not None:
        acts["ffn_in"] = ffn_in
    if cfg.is_moe:
        b, s, d = ffn_in.shape
        y = moe_lib.moe_apply({k: lp[k] for k in ("router", "we1", "we3", "we2")},
                              ffn_in.reshape(b * s, d), cfg, pctx).reshape(b, s, d)
    else:
        y = mlp_apply(lp, ffn_in, cfg.mlp_kind, acts=acts)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# Stack (a loop over layers)
# ---------------------------------------------------------------------------
_CACHE_KEYS = {"dense": ("k", "v"), "quant": ("k", "v", "ks", "vs"),
               "static": ("k", "v", "k_scale", "v_scale"),
               "paged": ("k", "v", "pages"),
               "paged_static": ("k", "v", "pages", "k_scale", "v_scale")}


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
    remat: bool = False,
    attn_impl: str = "flash",
) -> tuple[torch.Tensor, dict | None]:
    """Run the block stack over its layers.

    ``collect=True`` (cache-less forward only) returns, in the second slot,
    the stacked per-layer activations: ``"block_out"`` (``[L, B, S, D]``)
    plus each block's matmul inputs, and with ``tap_kv`` the post-RoPE
    ``"k_cache"``/``"v_cache"`` (``[L, B, S, KV, hd]``). With a cache the
    second slot is the cache dict, written in place. ``remat`` (cache-less,
    not with ``collect``) recomputes each block in the backward pass;
    ``attn_impl`` as in :func:`_attention`.
    """
    if collect and cache is not None:
        raise ValueError("collect=True is for the cache-less forward")
    if remat and (collect or cache is not None):
        raise ValueError("remat is for the cache-less forward without collect")
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_embed(positions, cfg.hd, cfg.rope_theta)
    rope = (cos, sin, cos, sin)  # new keys share the query positions

    layout = "dense" if cache is None else cache_layout(cache)
    ys: list[dict] = []
    for i in range(blocks["ln1"].shape[0]):
        lp = layer_params(blocks, i)
        if cache is not None:
            # the page table is shared by every layer; the rest is per layer
            kvc = tuple(cache[key] if key == "pages" else cache[key][i]
                        for key in _CACHE_KEYS[layout])
            x, _ = block_apply(lp, cfg, x, rope=rope, causal=causal, window=window, kv_cache=kvc,
                               kv_layout=layout, cache_pos=cache_pos, enc_out=enc_out, pctx=pctx)
            continue
        acts: dict | None = {} if (collect or tap_kv) else None

        def block(lp_, x_):
            return block_apply(lp_, cfg, x_, rope=rope, causal=causal, window=window,
                               enc_out=enc_out, pctx=pctx, acts=acts, tap_kv=tap_kv,
                               attn_impl=attn_impl)[0]

        x = remat_call(block, lp, x) if remat else block(lp, x)
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
    """Token embeddings ``[B, S, D]``; with ``frontend`` (precomputed patch embeddings
    ``[B, F, D]``) their ``frontend_proj`` image prepended: ``[B, F + S, D]``."""
    dev = params["embed"].device
    x = params["embed"][torch.as_tensor(tokens).to(dev).long()].to(cfg.dtype)
    if frontend is not None:
        fe = matmul(torch.as_tensor(frontend).to(dev).to(cfg.dtype), params["frontend_proj"])
        x = torch.cat([fe, x], dim=1)
    return x


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


def remat_call(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass instead of
    kept (``jax.checkpoint`` in the JAX package)."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False)


def _logits(params, cfg: ArchConfig, tokens, *, frontend=None, pctx=None, tap=None,
            tap_kv: bool = False, remat: bool = False, attn_impl: str = "flash"):
    x = embed_tokens(params, cfg, tokens, frontend)
    if tap is not None:
        x = tap("embed", x)
    x, ys = stack_apply(params["blocks"], cfg, x, causal=True, window=cfg.window, pctx=pctx,
                        collect=tap is not None, tap_kv=tap_kv, remat=remat,
                        attn_impl=attn_impl)
    if tap is not None:
        tap("blocks", ys.pop("block_out"))
        for site, act in ys.items():
            tap(site, act)
        x = tap("final", x)
    return unembed(params, cfg, x)


def forward(params, cfg: ArchConfig, tokens, *, frontend=None, pctx=None, tap=None,
            tap_kv: bool = False) -> torch.Tensor:
    """Cache-less forward without gradients: logits ``[B, S(+F), V]`` (float32),
    prefill-shaped attention on the flash kernel.

    ``tap`` is the activation-tap hook of the calibration contract: sites
    ``"embed"``, ``"blocks"`` (stacked block outputs ``[L, B, S, D]``), the
    stacked matmul inputs ``"attn_in"``/``"attn_mix"``/``"ffn_in"``/
    ``"ffn_hidden"`` and ``"final"``; ``tap_kv=True`` adds the post-RoPE
    ``"k_cache"``/``"v_cache"`` sites (``[L, B, S, KV, hd]``).
    """
    with torch.no_grad():
        return _logits(params, cfg, tokens, frontend=frontend, pctx=pctx, tap=tap, tap_kv=tap_kv)


def loss_fn(params, cfg: ArchConfig, tokens, labels, *, frontend=None, pctx=None,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy (labels already shifted by the data pipeline),
    differentiable: the cache-less forward with the reference's attention
    (``attn_impl="reference"``), each block recomputed in the backward pass with
    ``remat``. Frontend positions (if any) are left out of the loss."""
    logits = _logits(params, cfg, tokens, frontend=frontend, pctx=pctx, remat=remat,
                     attn_impl="reference")
    if frontend is not None:
        logits = logits[:, frontend.shape[1]:]
    return cross_entropy(logits, labels)


def prefill(params, cfg: ArchConfig, tokens, cache: dict, *, frontend=None, pctx=None):
    """Fill the cache with the prompt (after the ``frontend`` embeddings, if any);
    return the last position's logits and the cache."""
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
        pos, positions = step_positions(pos, token.shape[1], params["embed"].device)
        x = embed_tokens(params, cfg, token)
        x, cache = stack_apply(params["blocks"], cfg, x, causal=True, window=cfg.window,
                               positions=positions, cache=cache, cache_pos=pos, pctx=pctx)
        return unembed(params, cfg, x), cache


def step_positions(pos, s: int, device) -> tuple:
    """``(pos, positions)`` of a decode run of ``s`` tokens a row: ``pos`` as an int
    or a ``[B]`` tensor on ``device``, and the tokens' positions ``[1 or B, s]``."""
    pos = _as_pos(pos)
    ar = torch.arange(s, device=device)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device)
        return pos, pos[:, None] + ar[None, :]
    return pos, (pos + ar)[None, :]
