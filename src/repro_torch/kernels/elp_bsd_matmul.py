"""Tiled ELP_BSD decode + matmul: the Hopper kernels, their plain version, the wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/elp_bsd_matmul.py::elp_bsd_matmul`` (body ``_mm_kernel``):
``out[M, N] = (x[M, K] @ decode(codes)[K, N]) * sf`` with codes uint8
``[K, N]`` or nibble-packed ``[K/2, N]`` (low nibble = even row) and one
float32 scale factor.

Three routes, each its own CUDA C++ kernel for ``sm_90a``; :func:`route`
picks one before any launch, by one rule:

* ``"wgmma"`` (``csrc/elp_bsd_matmul_wgmma.cu``): bf16 x and a format whose
  decoded values are all exact in bf16 (:func:`repro_torch.kernels.ref.bf16_exact`,
  true for every preset). x stays bf16 and the product runs on the tensor
  cores (``wgmma``, float32 sums), operands fed by TMA through a ring of
  shared-memory stages, codes decoded by a byte-indexed table
  (:func:`repro_torch.kernels.ref.decode_table`). A bf16 x times an exact
  bf16 weight is exact in float32, so it forms the reference's products;
  only the order of the float32 sums differs. The LM prefill runs here.
* ``"bf16x3"`` (the second kernel of the same source): float32 or float16
  x (as float32) and a bf16-exact format. The kernel splits each x tile
  exactly into three bf16 terms, ``x = hi + mid + lo``
  (:func:`repro_torch.kernels.ref.split_bf16x3`), in shared memory, and
  sums the three terms' tensor-core products into one float32
  accumulator: each product is exact, so only the order of the float32
  sums differs from the reference. The AlexNet convs run here.
* ``"f32"`` (``csrc/elp_bsd_matmul.cu``): a format that is not bf16-exact
  (or an x of another type), x cast to float32, on CUDA cores: a
  128 x 128 output tile per block, a K loop inside the block, x and code
  tiles staged and decoded (shift-add) in shared memory, an 8 x 8 float32
  micro-tile per thread, capped at the H100's CUDA-core rate (67 TFLOP/s).

TMA needs a 16-byte aligned base and row stride: x or codes without them
are first copied once into a buffer with padded rows. An x that is a
row-strided view with such rows goes as it is: ``kernels/conv.py`` writes
the im2col patches so, for conv0's K = 363.

All three mask ragged edges and split K over several blocks per tile
(summed by a deterministic second pass) where the tiles alone would leave
SMs idle in the last wave; each kernel picks that split from its own
tiles and occupancy. The decoded weight never reaches device memory. A failed
build or launch raises: nothing retries on another route.

:func:`elp_bsd_matmul` takes the plain version (:func:`elp_bsd_matmul_plain`)
only for tensors on the CPU; on a CUDA tensor it launches the routed kernel
or raises. ``elp_bsd_matmul.launches`` counts every route's launches and
``elp_bsd_matmul.launches_by_route[route]`` each one's. An input that
requires grad, with grad mode on, raises (:func:`refuse_grad`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.kernels.ref import (
    bf16_exact,
    decode_table,
    decode_values_shift_add,
    unpack_nibbles_k,
)

ROUTES = ("wgmma", "bf16x3", "f32")


def elp_bsd_matmul_plain(
    x: torch.Tensor,
    codes: torch.Tensor,
    sf: torch.Tensor,
    fmt: ElpBsdFormat,
    *,
    nibble: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: decode, float32 product, then ``* sf``.

    In nibble mode an odd K drops the pad row's code, as the kernel does.
    """
    w = decode_values_shift_add(unpack_nibbles_k(codes) if nibble else codes, fmt)
    out = torch.matmul(x.to(torch.float32), w[: x.shape[1]]) * sf.reshape(())
    return out.to(out_dtype or x.dtype)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: the kernels write
    fresh tensors outside autograd and have no backward (neither have the JAX
    package's), so a gradient would drop silently. The plain version of the
    CPU path is refused alike, so both devices behave the same. The training
    forward takes the reference's torch ops instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on inputs that do not "
            "require grad (the training forward does not run the kernels)")


def check_kernel_args(name: str, x, codes, nibble: bool) -> int:
    """The Pallas kernels' operand contract; returns N. Raises ValueError.

    Any M, K and N go: the CUDA kernels mask their ragged edges. Nibble
    codes hold ``ceil(K/2)`` rows (an odd K carries the pad row).
    """
    if x.ndim != 2 or codes.ndim != 2:
        raise ValueError(
            f"{name} takes x[M, K] and codes[K', N]; got x{tuple(x.shape)}, "
            f"codes{tuple(codes.shape)}"
        )
    kdim = x.shape[1]
    if nibble:
        k2, n = codes.shape
        if k2 != (kdim + 1) // 2:
            raise ValueError(
                f"nibble codes pack two K rows per byte: expected codes[ceil(K/2)="
                f"{(kdim + 1) // 2}, N], got codes{tuple(codes.shape)} against x{tuple(x.shape)}"
            )
    else:
        kc, n = codes.shape
        if kc != kdim:
            raise ValueError(
                f"codes K dim must match x: got codes{tuple(codes.shape)} "
                f"against x{tuple(x.shape)}"
            )
    return n


def as_scale(sf, device: torch.device) -> torch.Tensor:
    """One float32 scale factor on ``device`` (a tensor of one element or a number)."""
    s = torch.as_tensor(sf, dtype=torch.float32).to(device)
    if s.numel() != 1:
        raise ValueError(f"the kernel takes one scale factor; got sf of shape {tuple(s.shape)}")
    return s.reshape(1)


def _check_operands(name: str, x, codes, sf) -> None:
    """One device for all three operands and uint8 codes; raises ValueError/TypeError."""
    if codes.device != x.device or sf.device != x.device:
        raise ValueError(
            f"{name}: x, codes and sf must share a device; got {x.device}, {codes.device}, "
            f"{sf.device}"
        )
    if codes.dtype != torch.uint8:
        raise TypeError(f"{name}: codes must be uint8, got {codes.dtype}")


def launch_checked(name: str, x, codes, sf, fmt, nibble: bool) -> torch.Tensor:
    """Validate devices and dtypes, then launch the float32 kernel ``csrc/<name>.cu``
    on x cast to float32; float32 ``[M, N]`` out."""
    from repro_torch import _build

    _check_operands(name, x, codes, sf)
    xf = x.to(torch.float32).contiguous()
    c = codes.contiguous()
    out = torch.empty((x.shape[0], codes.shape[1]), dtype=torch.float32, device=x.device)
    _build.launch(name, xf, c, sf, out, nibble, fmt)
    return out


def route(x: torch.Tensor, fmt: ElpBsdFormat) -> str:
    """The kernel :func:`elp_bsd_matmul` launches for a CUDA ``x``. With a
    :func:`~repro_torch.kernels.ref.bf16_exact` format: ``"wgmma"`` for bf16
    ``x``, ``"bf16x3"`` for float32 or float16 ``x``; else ``"f32"``."""
    if bf16_exact(fmt):
        if x.dtype == torch.bfloat16:
            return "wgmma"
        if x.dtype in (torch.float32, torch.float16):
            return "bf16x3"
    return "f32"


@functools.lru_cache(maxsize=None)
def _table_words(fmt: ElpBsdFormat, nibble: bool) -> ctypes.Array:
    """:func:`decode_table` as the 256 unsigned words the wgmma kernel's entry point reads."""
    return (ctypes.c_uint32 * 256)(*(v & 0xFFFFFFFF for v in decode_table(fmt, nibble).tolist()))


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (2-D) with a 16-byte aligned base and row stride and unit column
    stride, as TMA reads it: ``t`` itself when it already has them (a
    row-strided view included), else a copy into a zero buffer whose rows
    are padded to a multiple of 16 bytes."""
    if (t.stride(1) == 1 and t.stride(0) >= t.shape[1] and t.data_ptr() % 16 == 0
            and t.stride(0) * t.element_size() % 16 == 0):
        return t
    t = t.contiguous()
    row = t.shape[1] * t.element_size()
    if t.data_ptr() % 16 == 0 and row % 16 == 0:
        return t
    cols = -(-row // 16) * 16 // t.element_size()
    padded = t.new_zeros((t.shape[0], cols))
    padded[:, : t.shape[1]] = t
    return padded


def launch_wgmma(x, codes, sf, fmt, nibble: bool, name: str = "elp_bsd_matmul_wgmma",
                 route: str = "wgmma") -> torch.Tensor:
    """Validate devices and dtypes, then launch route ``route`` of the tensor-core
    kernel ``csrc/<name>.cu`` (this module's, or the decode-step kernel's):
    ``"wgmma"`` on bf16 ``x`` as it is, ``"bf16x3"`` on float32 or float16
    ``x`` as float32; float32 ``[M, N]`` out."""
    from repro_torch import _build

    _check_operands(name, x, codes, sf)
    if route == "wgmma" and x.dtype != torch.bfloat16:
        raise TypeError(f"the wgmma route takes bfloat16 x, got {x.dtype}")
    if route == "bf16x3":
        if x.dtype not in (torch.float32, torch.float16):
            raise TypeError(f"the bf16x3 route takes float32 or float16 x, got {x.dtype}")
        x = x.to(torch.float32)
    table = _table_words(fmt, nibble)
    out = torch.empty((x.shape[0], codes.shape[1]), dtype=torch.float32, device=x.device)
    _build.launch_tensor_core(name, "bf16" if route == "wgmma" else route, _tma_rows(x),
                              x.shape[1], _tma_rows(codes), sf, out, nibble, table)
    return out


def elp_bsd_matmul(
    x: torch.Tensor,
    codes: torch.Tensor,
    sf,
    fmt: ElpBsdFormat,
    *,
    nibble: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x[M, K] @ dequant(codes)[K, N]`` with the decode inside the kernel.

    Any M, K and N: the kernels mask the ragged edges, so K rows past the
    logical K (the nibble pad row) meet zero activations. ``sf`` is one
    float32 scale factor. On the card the kernel is :func:`route`'s.
    """
    check_kernel_args("elp_bsd_matmul", x, codes, nibble)
    refuse_grad("elp_bsd_matmul", x)
    out_dtype = out_dtype or x.dtype
    sf = as_scale(sf, x.device)
    if x.device.type == "cpu":
        return elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"elp_bsd_matmul runs on cuda or cpu tensors, got {x.device}")
    r = route(x, fmt)
    if r in ("wgmma", "bf16x3"):
        out = launch_wgmma(x, codes, sf, fmt, nibble, route=r)
    else:
        out = launch_checked("elp_bsd_matmul", x, codes, sf, fmt, nibble)
    elp_bsd_matmul.launches += 1
    elp_bsd_matmul.launches_by_route[r] += 1
    return out.to(out_dtype)


elp_bsd_matmul.launches = 0
elp_bsd_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
