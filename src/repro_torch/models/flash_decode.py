"""Flash-decoding: decode-step attention over a sequence-sharded KV cache.

The JAX package's ``repro/models/flash_decode.py`` over
``torch.distributed``. The cache's SEQUENCE is sharded over the model
axis; each rank computes the softmax statistics of its query against
its own slice of the sequence, and the ranks exchange only those:

    per rank:  m, l, acc  =  max / sum-exp / weighted V  over s_loc
    combine:   M = max(m);  out = sum(acc e^(m - M)) / sum(l e^(m - M))

``[B, H, sq(, hd)]`` floats instead of a ``[B, H, sq, S]`` partial-sum
reduction. The JAX package writes this under ``shard_map`` with
``lax.pmax`` and ``lax.psum``; here each rank calls the function on its
local tensors and the combine is an ``all_reduce(MAX)`` of ``m`` and one
``all_reduce(SUM)`` of the rescaled ``l`` and ``acc`` (the reference's two
``psum`` s in one message) over the model axis's process group
(:mod:`repro_torch.runtime.collectives`). The batch rides the batch axes
as the cache does (:func:`batch_sharded`); a rank's sequence slice starts
at ``model_rank * s_loc``. On a model axis that also splits the heads the
caller gathers the query heads whole first, so each rank computes the
statistics of every head over its slice
(:func:`repro_torch.models.transformer._attention`).

A paged cache feeds this through its LOGICAL view (the transformer
gathers, and for int8 codes dequantizes, ``[B, Pmax * page, KV, hd]``
first), so the sequence slicing never sees page boundaries. Plain torch
ops in float32, as the reference leaves this to XLA (it has no Pallas
kernel). ``block_s=None`` takes the autotune cache's chunk for the shape
(:func:`repro_torch.bench.autotune.lookup_flash_block_s`), and the one-shot
slice on a miss, as the reference does; ``block_s=0`` is the one-shot slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.bench import autotune
from repro_torch.device import full_f32
from repro_torch.runtime import collectives

F32 = torch.float32
NEG = -1e30


def batch_sharded(b: int, pctx) -> bool:
    """Whether a decode batch of ``b`` rows is split over the batch axes (else
    every batch rank holds all of it), the reference's choice of layout."""
    nb = pctx.batch_size
    return b % nb == 0 and b >= nb


def _chunk_stats(qf, kf, vf, kpos, qpos, *, window: int):
    """Softmax statistics (m, l, acc) of ``qf`` against one key/value chunk."""
    with full_f32():
        logits = torch.einsum("bqhd,bshd->bhqs", qf, kf)  # [B, H, sq, s_chunk]
    kp = kpos.reshape(1, 1, 1, -1)
    mask = kp <= qpos  # [B|1, 1, sq, s_chunk], broadcast over H
    if window:
        mask = mask & ((qpos - kp) < window)
    logits = torch.where(mask, logits, torch.tensor(NEG, dtype=F32, device=logits.device))
    m = torch.amax(logits, dim=-1)  # [B, H, sq]
    p = torch.exp(logits - m[..., None])
    l = torch.sum(p, dim=-1)
    with full_f32():
        acc = torch.einsum("bhqs,bshd->bhqd", p, vf)  # [B, H, sq, hd]
    return m, l, acc


def _local_stats(q, k, v, ks, vs, pos, *, start: int, window: int, n_rep: int,
                 block_s: int | None):
    """This rank's statistics: ``q[B, sq, H, hd]`` against ``k/v[B, s_loc, KV, hd]``
    (int8 with per-(token, head) scales ``ks``/``vs``, or float), keys at
    positions ``start ..``. ``pos`` is a scalar or a ``[B]`` vector; query ``i`` of
    row ``b`` sits at ``pos[b] + i`` (a speculative verify run when ``sq > 1``).
    ``block_s`` streams the slice through the same running-max rescale in
    chunks; ``None`` or 0 (or a block that does not tile the slice) is one shot."""
    b, sq, h, hd = q.shape
    s_loc = k.shape[1]
    dev = q.device
    pos = torch.as_tensor(pos, device=dev).to(torch.int64)
    qpos = pos.reshape(-1, 1, 1, 1) + torch.arange(sq, device=dev).reshape(1, 1, sq, 1)
    kf = k.to(F32) if ks is None else k.to(F32) * ks
    vf = v.to(F32) if vs is None else v.to(F32) * vs
    kf = torch.repeat_interleave(kf, n_rep, dim=2)  # [B, s, H, hd]
    vf = torch.repeat_interleave(vf, n_rep, dim=2)
    qf = q.to(F32) * (1.0 / math.sqrt(hd))
    if not block_s or block_s >= s_loc or s_loc % block_s:
        kpos = start + torch.arange(s_loc, device=dev)
        return _chunk_stats(qf, kf, vf, kpos, qpos, window=window)
    m = torch.full((b, h, sq), -math.inf, dtype=F32, device=dev)
    l = torch.zeros((b, h, sq), dtype=F32, device=dev)
    acc = torch.zeros((b, h, sq, hd), dtype=F32, device=dev)
    for c in range(s_loc // block_s):
        sl = slice(c * block_s, (c + 1) * block_s)
        kpos = start + c * block_s + torch.arange(block_s, device=dev)
        mc, lc, ac = _chunk_stats(qf, kf[:, sl], vf[:, sl], kpos, qpos, window=window)
        mn = torch.maximum(m, mc)
        cr, crc = torch.exp(m - mn), torch.exp(mc - mn)
        m = mn
        l = l * cr + lc * crc
        acc = acc * cr[..., None] + ac * crc[..., None]
    return m, l, acc


def flash_decode_attention(q, ck, cv, pos, *, pctx, window: int = 0, ks=None, vs=None,
                           block_s: int | None = None) -> torch.Tensor:
    """``q[B, sq, H, hd]`` against this rank's sequence slice ``ck/cv[B, s_loc, KV,
    hd]`` of a cache sharded over ``pctx.model_axis``: the attention output
    ``[B, sq, H, hd]`` in ``q``'s dtype, the same on every rank of the model axis.

    ``ks``/``vs`` are per-(token, head) scales of an int8 cache, dequantized
    on the rank. ``pos`` is a scalar or this rank's ``[B]`` rows' positions.
    ``block_s=None`` looks the chunk up at (this rank's rows, ``H``, ``hd``, the
    whole sequence ``s_loc * model_size``).
    """
    h, kv = q.shape[2], ck.shape[2]
    s_loc = ck.shape[1]
    if block_s is None:
        block_s = autotune.lookup_flash_block_s(q.shape[0], h, q.shape[3],
                                                s_loc * pctx.model_size,
                                                backend=autotune.backend_of(q))
    m, l, acc = _local_stats(q, ck, cv, ks, vs, pos, start=pctx.model_rank * s_loc,
                             window=window, n_rep=h // kv, block_s=block_s)
    group = pctx.model_group
    mg = collectives.all_reduce(m.clone(), group, "max")
    corr = torch.exp(m - mg)
    la = collectives.all_reduce(torch.cat([(l * corr)[..., None], acc * corr[..., None]], -1),
                                group)
    out = la[..., 1:] / torch.clamp(la[..., :1], min=1e-30)
    return out.movedim(1, 2).to(q.dtype)  # [B, sq, H, hd]
