"""Shared neural layers: norms, RoPE, GQA attention, MLPs, the matmul front door.

Plain functions on tensors with the JAX package's conventions
(``repro/models/layers.py``): activations ``[B, S, D]``, attention heads
``[B, S, H, hd]``, weights ``[in, out]``, float32 accumulation, outputs
in the input's dtype.

The JAX module shapes three things around XLA's partitioner and loop
hoisting: rotate-half as a product with a constant ±1 matrix
(``_rot_half_matrix``), ``concat([t, t])`` as broadcast + reshape
(``_tile2``) and an f32 reduction dtype in ``rms_norm`` instead of an f32
copy of ``x``. Eager PyTorch has neither problem, so they are written in
plain idiom here: slice + concatenate for rotate-half is exact (the JAX
contraction has one ±1 per column and zeros elsewhere, so each output is
exactly ``±x`` of one input), and ``rms_norm`` converts the squares to
float32 before the mean.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30  # the masked logit of the JAX package (not -inf)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)``: squares in ``x.dtype`` summed in float32, as in the
    JAX package, and the products in ``x.dtype``."""
    var = torch.mean(torch.square(x).to(F32), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_embed(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """cos/sin tables ``[..., head_dim/2]`` for the given positions."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=F32, device=positions.device) / half
    )
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x[B, S, H, hd]`` with tables ``[B?, S, hd/2]`` (rotate-half form)."""
    while cos.ndim < x.ndim:  # broadcast over the head dim
        cos, sin = cos[..., None, :], sin[..., None, :]
    xf = x.to(F32)
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * torch.cat([cos, cos], -1) + rot * torch.cat([sin, sin], -1)).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[B, S, KV, hd] -> [B, S, KV*n_rep, hd]`` for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def _query_positions(q_offset, sq: int, device) -> torch.Tensor:
    """``[sq]`` for a shared offset, ``[B, sq]`` for per-row offsets."""
    off = torch.as_tensor(q_offset, device=device)
    ar = torch.arange(sq, device=device)
    return off[:, None] + ar if off.ndim == 1 else off + ar


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    mask = torch.ones(qpos.shape + kpos.shape, dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= qpos[..., None] >= kpos
    if window:
        mask &= qpos[..., None] - kpos < window
    # [sq, sk] -> [1, 1, sq, sk]; [B, sq, sk] -> [B, 1, sq, sk]
    return mask[:, None] if mask.ndim == 3 else mask[None, None]


def attention_dot(q, k, v, *, causal: bool = True, window: int = 0, q_offset=0) -> torch.Tensor:
    """Plain O(S^2) attention. ``q[B, Sq, H, hd]``, ``k/v[B, Sk, H, hd]``.

    ``q_offset`` positions the queries for causal/window masking: a scalar
    offsets every row alike, a ``[B]`` vector gives each row its own.
    """
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32)) * scale
    qpos = _query_positions(q_offset, sq, q.device)
    mask = _mask(qpos, torch.arange(sk, device=q.device), causal, window)
    logits = torch.where(mask, logits, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(F32))
    return out.to(q.dtype)


def attention_chunked(
    q, k, v, *, causal: bool = True, window: int = 0, chunk: int = 1024, q_offset=0
) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with running max/sum.

    Memory O(Sq * chunk); equals :func:`attention_dot` to float tolerance.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sk % chunk != 0:
        raise ValueError(f"key length {sk} must tile by chunk {chunk}")
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(F32) * scale
    qpos = _query_positions(q_offset, sq, q.device)
    neg = torch.tensor(NEG_INF, dtype=F32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=F32, device=q.device)
    for c in range(sk // chunk):
        kb = k[:, c * chunk:(c + 1) * chunk].to(F32)
        vb = v[:, c * chunk:(c + 1) * chunk].to(F32)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        logits = torch.where(_mask(qpos, kpos, causal, window), logits, neg)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# The recurrent families' elementwise pieces
# ---------------------------------------------------------------------------
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` defines it, ``logaddexp(x, 0)``
    (``F.softplus`` returns ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                left: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d of ``x[B, S, C]`` with ``w[cw, C]`` and bias ``b[C]``.

    ``left`` (``[B, cw - 1, C]``, a cached window) is the context before
    ``x``; without it ``x`` is zero-padded on the left, as the JAX package's
    ``_causal_conv`` does. The conv is the sum of ``cw`` shifted elementwise
    products in float32 (no TF32 on the card, where a cuDNN conv may round
    its inputs), cast back to ``x.dtype`` after the bias.
    """
    cw, s = w.shape[0], x.shape[1]
    if left is None:
        xp = F.pad(x.to(F32), (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([left.to(x.dtype), x], dim=1).to(F32)
    wf = w.to(F32)
    out = xp[:, 0:s] * wf[0]
    for j in range(1, cw):
        out = out + xp[:, j:j + s] * wf[j]
    return (out + b.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs and the matmul front door
# ---------------------------------------------------------------------------
def mlp_apply(p: dict, x: torch.Tensor, kind: str, acts: dict | None = None) -> torch.Tensor:
    """``kind``: ``"swiglu"``/``"geglu"`` (w1, w3, w2) or ``"gelu"`` (w1, w2).

    ``acts`` (calibration collection) records the hidden activation
    entering ``w2`` under ``"ffn_hidden"``.
    """
    if kind == "swiglu":
        h = F.silu(matmul(x, p["w1"])) * matmul(x, p["w3"])
    elif kind == "geglu":
        h = F.gelu(matmul(x, p["w1"]), approximate="tanh") * matmul(x, p["w3"])
    elif kind == "gelu":
        h = F.gelu(matmul(x, p["w1"]), approximate="tanh")
    else:
        raise ValueError(kind)
    if acts is not None:
        acts["ffn_hidden"] = h
    return matmul(h, p["w2"])


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x[..., in] @ w[in, out]``, output in ``x.dtype``.

    ``w`` may be a :class:`~repro_torch.kernels.ops.PackedWeight` (one
    layer's ``[K, N]`` codes): the product then runs on the codes through
    :func:`~repro_torch.kernels.ops.quantized_matmul`, on the card the
    decode-step kernel for M <= 256 rows and the tiled kernel above. A
    float weight is a plain product (float32 accumulation).
    """
    from repro_torch.kernels.ops import PackedWeight, quantized_matmul

    if isinstance(w, PackedWeight):
        return quantized_matmul(x, w, impl="auto", out_dtype=x.dtype)
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over every position, in float32: the
    log-sum-exp about the row max (held constant for the gradient, as the JAX
    package's ``stop_gradient``) minus the gold logit."""
    lf = logits.to(F32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lf - m), dim=-1))
    gold = torch.gather(lf, -1, labels.to(lf.device).long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def dense_init(
    gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype = F32, scale: float = 1.0,
    device=None,
) -> torch.Tensor:
    """Truncated-normal fan-in init (He-style): N(0, 1) cut at ±2, times ``scale/sqrt(fan_in)``.

    ``fan_in`` is ``shape[0]``, as in the JAX package. The draws come from
    ``gen`` on its own device and the result moves to ``device`` (default:
    ``gen``'s), so a host generator gives the same numbers on any device.
    They are not ``jax.random``'s bits.
    """
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=F32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype=dtype, device=device or gen.device)
