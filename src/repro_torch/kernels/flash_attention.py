"""Flash attention (prefill): the Hopper kernel, its plain version, its wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body
``_flash_kernel``): attention over ``q/k/v [B, H, S, hd]`` with an online
softmax whose running max, running sum and accumulator are float32, scale
``1/sqrt(hd)`` applied to q, a causal mask by absolute position, masked
logits ``-1e30``, the running sum clamped at ``1e-30`` and the output in
``q.dtype``.

Two CUDA C++ kernels for ``sm_90a`` compute it, one block per
(batch*head, 64-query tile) looping over 64-key tiles with m, l and the
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
* ``"f32"`` (``csrc/flash_attention.cu``): anything else (float32), in
  float32 on CUDA cores with the query tile and K and V staged in shared
  memory.

A failed build or launch raises: nothing retries on the other route.

Beyond the JAX signature the wrapper takes k and v with fewer heads than q
(grouped-query attention: head ``h`` reads key head ``h // (H // KVH)``,
so the caller does not repeat them), any strides with a unit stride along
``hd`` (a ``[B, S, H, hd]`` activation viewed as ``[B, H, S, hd]`` is read
in place, and the output has q's strides), and a ``q_offset`` that places
the queries at absolute positions ``q_offset ..`` for the causal mask
(prefill into a cache that already holds ``q_offset`` positions).

:func:`flash_attention` takes the plain version
(:func:`flash_attention_plain`) only for tensors on the CPU; on a CUDA
tensor it launches the routed kernel or raises. ``flash_attention.launches``
counts both kernels' launches and ``flash_attention.launches_by_route[route]``
each one's.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.models.layers import NEG_INF

F32 = torch.float32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 128  # the CUDA kernels' widest head
ROUTES = ("wgmma", "f32")


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
    if s % block_q != 0 or sk % block_k != 0:
        raise ValueError(
            f"sequence lengths must tile by the block sizes: s={s} "
            f"block_q={block_q}, sk={sk} block_k={block_k} (callers pad)"
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
    q, k and v are all bf16, else ``"f32"``."""
    return "wgmma" if q.dtype == k.dtype == v.dtype == torch.bfloat16 else "f32"


def _signatures(name: str) -> dict:
    # every pointer and the stream as c_void_p (undeclared, ctypes would cut them to 32 bits);
    # the float32 kernel's entry point also takes the dtype code
    ints = 7 if name == "flash_attention" else 6
    return {
        f"{name}_launch": (
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

    name = "flash_attention_wgmma" if r == "wgmma" else "flash_attention"
    if r == "wgmma":
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    lib = _build.load(name, _signatures(name))
    strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    dtype = () if r == "wgmma" else (DTYPE_CODES[q.dtype],)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dtype,
            b, h, group, sq, sk, hd, strides, int(causal), int(q_offset),
            1.0 / math.sqrt(hd), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (q{tuple(q.shape)}, "
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

    S and Sk must tile by the block sizes (callers pad), as in the JAX
    package; returns ``[B, H, S, hd]`` in ``q.dtype`` with q's strides.
    ``q_offset`` is the absolute position of the first query (causal mask).
    """
    group, _ = _check(q, k, v, block_q, block_k)
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must share a device; got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the kernel takes q, k and v of one dtype among {sorted(map(str, DTYPE_CODES))}; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.shape[3] > MAX_HD:
        raise ValueError(f"the CUDA kernel takes head_dim <= {MAX_HD}, got {q.shape[3]}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    r = route(q, k, v)
    _launch(r, q, k, v, out, group, causal, q_offset)
    flash_attention.launches += 1
    flash_attention.launches_by_route[r] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
