"""Flash attention (prefill): the Hopper kernel, its plain version, its wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body
``_flash_kernel``): attention over ``q/k/v [B, H, S, hd]`` with an online
softmax whose running max, running sum and accumulator are float32, scale
``1/sqrt(hd)`` applied to q, a causal mask by absolute position, masked
logits ``-1e30``, the running sum clamped at ``1e-30`` and the output in
``q.dtype``.

Three CUDA C++ kernels for ``sm_90a`` compute it, one block per
(batch*head, query tile) looping over 64-key tiles with m, l and the
accumulator in float32 registers and causal blocks stopping at their
diagonal tile; :func:`route` picks one before any launch, by one rule:

* ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 q, k and v. The
  products run on the tensor cores (``wgmma``), q, k and v fed by TMA
  through a 2-stage ring; P·V adds ``bf16(P)·V`` and
  ``bf16(P - bf16(P))·V``, which keeps P to about 2^-16 as the
  reference's float32 P·V does. The LM prefill runs here. At qwen3-8b's
  prefill shape (q ``[16, 32, 128, 128]``, k and v with 8 heads) the
  causal work is 2.2 GFLOP against 42 MB of q, k, v and out: bytes-bound
  on an H100 (12.5 us at 3.35 TB/s).
* ``"bf16x3"`` (the same source's second kernel): float32 q, k and v. q
  (scaled by ``1/sqrt(hd)`` in float32, as the reference scales it), k, v
  and P are each split exactly into three bf16 terms
  (:func:`repro_torch.kernels.ref.split_bf16x3`) and each product is a sum
  of float32 cross-products of the terms on the tensor cores, six for
  ``Q K^T`` and five for ``P V`` (:data:`repro_torch.kernels.ref.FLASH_PRODUCTS`;
  :func:`repro_torch.kernels.ref.flash_attention_bf16x3` models it). A
  splitter warpgroup splits the float32 tiles TMA loads for two consumer
  warpgroups of 64 query rows, which take turns on the tensor cores; each
  tile's ``P V`` is summed into a zeroed accumulator and added into a
  float32 register sum. Every float32 call (the float32 LMs' prefill) runs
  here.
* ``"f32"`` (``csrc/flash_attention.cu``): float32 on CUDA cores with the
  query tile and K and V staged in shared memory. No call of the wrapper
  reaches it (q, k and v of one dtype are bf16 or float32); it stays as
  the CUDA-core kernel the bf16x3 route replaced, launched directly
  (:func:`_launch`) to time it beside it.

A failed build or launch raises: nothing retries on the other route.

Beyond the JAX signature the wrapper takes k and v with fewer heads than q
(grouped-query attention: head ``h`` reads key head ``h // (H // KVH)``,
so the caller does not repeat them), any strides with a unit stride along
``hd`` (a ``[B, S, H, hd]`` activation viewed as ``[B, H, S, hd]`` is read
in place, and the output has q's strides), and a ``q_offset`` that places
the queries at absolute positions ``q_offset ..`` for the causal mask
(prefill into a cache that already holds ``q_offset`` positions). Sk
need not tile by ``block_k``: the kernels mask keys at ``kpos >= Sk``
(the tensor-core kernels' TMA loads read zeros past the tensor's extent), and
the plain version attends over the ``Sk`` keys it is given, so a
non-causal call never sees a padded key. The JAX kernel asks its callers
to pad Sk; with causal masking that padding lies past every query, but
without it each zero key would add ``exp(0 - m)`` to every row's softmax.

:func:`flash_attention` takes the plain version
(:func:`flash_attention_plain`) only for tensors on the CPU; on a CUDA
tensor it launches the routed kernel or raises. ``flash_attention.launches``
counts every kernel's launches and ``flash_attention.launches_by_route[route]``
each one's: real launches only. Inputs that require grad, with grad mode on,
raise (the kernels have no backward).

A ``meta`` q (the dry-run's abstract evaluation) is counted, never computed:
the wrapper returns an empty ``meta`` tensor of q's shape, dtype and strides
and launches nothing. Under an active cost counter
(:mod:`repro_torch.runtime.cost`) every call counts as one operation on every
device: ``4·hd`` FLOPs for each query-key pair the mask keeps (the QK and PV
products; every pair without ``causal``) and the bytes of q, k, v and the
output, each once, under :func:`route`'s route for a CUDA q of its dtype
(``"plain"`` on the CPU).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.elp_bsd_matmul import refuse_grad
from repro_torch.runtime import cost
from repro_torch.models.layers import NEG_INF

F32 = torch.float32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 128  # the CUDA kernels' widest head
ROUTES = ("wgmma", "bf16x3", "f32")


def _check(q, k, v, block_q: int, block_k: int) -> tuple[int, int]:
    """The JAX kernel's operand contract (plus GQA heads); returns (group, Sk)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash_attention takes q/k/v [B, H, S, hd]; got q{tuple(q.shape)}, "
            f"k{tuple(k.shape)}, v{tuple(v.shape)}"
        )
    b, h, s, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd or h % k.shape[1] != 0:
        raise ValueError(
            f"k and v must be [B, KVH, Sk, hd] with H % KVH == 0; got q{tuple(q.shape)}, "
            f"k{tuple(k.shape)}, v{tuple(v.shape)}"
        )
    sk = k.shape[2]
    if s % block_q != 0 or sk < 1:
        raise ValueError(
            f"sequence lengths must tile by the block sizes: s={s} "
            f"block_q={block_q} (callers pad the queries), sk={sk} (at least 1 key)"
        )
    return h // k.shape[1], sk


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the masked softmax materialised in float32.

    Same scale placement (on q), mask value and clamp as the kernel; k and v
    may have fewer heads than q (grouped-query attention).
    """
    h, sq, hd = q.shape[1], q.shape[2], q.shape[3]
    group = h // k.shape[1]
    qf = q.to(F32) * (1.0 / math.sqrt(hd))
    kf = k.to(F32).repeat_interleave(group, dim=1)
    vf = v.to(F32).repeat_interleave(group, dim=1)
    logits = torch.matmul(qf, kf.transpose(-1, -2))  # [B, H, Sq, Sk]
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(k.shape[2], device=q.device)
        logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    out = torch.matmul(p, vf) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.to(q.dtype)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel :func:`flash_attention` launches for CUDA tensors: ``"wgmma"`` when
    q, k and v are all bf16, else ``"bf16x3"`` (the wrapper has refused every
    other dtype but float32)."""
    return "wgmma" if q.dtype == k.dtype == v.dtype == torch.bfloat16 else "bf16x3"


# Each route's library (csrc/<name>.cu) and C entry point.
_ENTRY = {"wgmma": ("flash_attention_wgmma", "flash_attention_wgmma_launch"),
          "bf16x3": ("flash_attention_wgmma", "flash_attention_wgmma_bf16x3_launch"),
          "f32": ("flash_attention", "flash_attention_launch")}


def _signatures(r: str) -> dict:
    # every pointer and the stream as c_void_p (undeclared, ctypes would cut them to 32 bits);
    # the CUDA-core kernel's entry point also takes the dtype code
    ints = 7 if r == "f32" else 6
    return {
        _ENTRY[r][1]: (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
            ctypes.c_int,
        ),
    }


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` (unit stride along hd) as TMA reads it: ``t`` itself when its base
    is 16-byte aligned and its (batch, head, seq) strides are nonzero
    multiples of 16 bytes, else a view of a zero buffer with hd padded to a
    multiple of 8 elements that holds a copy."""
    if t.data_ptr() % 16 == 0 and all(s > 0 and s * t.element_size() % 16 == 0
                                      for s in t.stride()[:3]):
        return t
    hd = t.shape[3]
    buf = t.new_zeros((*t.shape[:3], -(-hd // 8) * 8))
    buf[..., :hd] = t
    return buf[..., :hd]


def _launch(r: str, q, k, v, out, group: int, causal: bool, q_offset: int) -> None:
    from repro_torch import _build

    name, entry = _ENTRY[r]
    if r != "f32":
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    lib = _build.load(name, _signatures(r))
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    dtype = (DTYPE_CODES[q.dtype],) if r == "f32" else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dtype,
            b, h, group, sq, sk, hd, strides, int(causal), int(q_offset),
            1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{entry} launch failed with code {err} (q{tuple(q.shape)}, "
            f"k{tuple(k.shape)}, {q.dtype}, causal={causal}, q_offset={q_offset}); "
            "-1 means the kernel refused the shape"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
    q_offset: int = 0,
) -> torch.Tensor:
    """Fused attention. ``q [B, H, S, hd]``, ``k/v [B, KVH, Sk, hd]`` (``H % KVH == 0``).

    On the card the kernel is :func:`route`'s.

    S must tile by ``block_q`` (callers pad the queries), as in the JAX
    package; Sk is any key count (the kernels mask past it); returns ``[B, H, S, hd]`` in ``q.dtype`` with q's strides.
    ``q_offset`` is the absolute position of the first query (causal mask).
    """
    group, _ = _check(q, k, v, block_q, block_k)
    refuse_grad("flash_attention", q, k, v)
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cpu":
        with cost.paused():  # the output in q's strides, as the kernels write it
            out = torch.empty_like(q).copy_(
                flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset))
        _count(q, k, v, out, causal, q_offset, "plain")
        return out
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors (or meta, counted "
                         f"only), got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must share a device; got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the kernel takes q, k and v of one dtype among {sorted(map(str, DTYPE_CODES))}; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.shape[3] > MAX_HD:
        raise ValueError(f"the CUDA kernel takes head_dim <= {MAX_HD}, got {q.shape[3]}")
    r = route(q, k, v)
    with cost.paused():
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
        out = torch.empty_like(q)
        if not q.is_meta:
            _launch(r, q, k, v, out, group, causal, q_offset)
            flash_attention.launches += 1
            flash_attention.launches_by_route[r] += 1
    _count(q, k, v, out, causal, q_offset, r)
    return out


def attention_pairs(sq: int, sk: int, causal: bool, q_offset: int = 0) -> int:
    """Query-key pairs of one (batch, head) that attention computes: query ``i`` at
    position ``q_offset + i`` sees keys ``0 .. min(q_offset + i, sk - 1)`` when
    causal, every key otherwise."""
    if not causal:
        return sq * sk
    # sum over i < sq of min(q_offset + i + 1, sk)
    full = max(0, min(sq, sk - q_offset))  # rows below the key count's cap
    rows = full * (q_offset + 1) + full * (full - 1) // 2
    return rows + (sq - full) * sk


def _count(q, k, v, out, causal: bool, q_offset: int, r: str) -> None:
    if cost.active() is None:
        return
    b, h, sq, hd = q.shape
    pairs = b * h * attention_pairs(sq, k.shape[2], causal, q_offset)
    nbytes = sum(cost.tensor_bytes(t) for t in (q, k, v, out))
    cost.kernel("flash_attention", r, 4.0 * hd * pairs, nbytes, out)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
