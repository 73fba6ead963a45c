"""Tiled ELP_BSD decode + matmul: the Hopper kernel, its plain version, its wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/elp_bsd_matmul.py::elp_bsd_matmul`` (body ``_mm_kernel``):
``out[M, N] = (x[M, K] @ decode(codes)[K, N]) * sf`` with codes uint8
``[K, N]`` or nibble-packed ``[K/2, N]`` (low nibble = even row) and one
float32 scale factor.

The kernel is ``csrc/elp_bsd_matmul.cu``, CUDA C++ for ``sm_90a``: one
block per 128 x 128 output tile, a K loop inside the block, x and code
tiles staged in shared memory, codes decoded there by shift-add, an
8 x 8 float32 micro-tile per thread, ragged edges masked, and K split over
several blocks per tile (summed by a deterministic second pass) where the
tiles alone would leave SMs idle in the last wave; the kernel's source
picks that split from its own tiles and occupancy. Its float32 arithmetic
caps it at the H100's CUDA-core rate (67 TFLOP/s); on the LM path's bf16
activations the work's own bound is the bf16 tensor-core rate, the
headroom for a later variant. The decoded weight never reaches device
memory.

:func:`elp_bsd_matmul` takes the plain version (:func:`elp_bsd_matmul_plain`)
only for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises. ``elp_bsd_matmul.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.kernels.ref import decode_values_shift_add, unpack_nibbles_k


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


def launch_checked(name: str, x, codes, sf, fmt, nibble: bool) -> torch.Tensor:
    """Validate devices and dtypes, then launch ``csrc/<name>.cu``; float32 ``[M, N]`` out."""
    from repro_torch import _build

    if codes.device != x.device or sf.device != x.device:
        raise ValueError(
            f"{name}: x, codes and sf must share a device; got {x.device}, {codes.device}, "
            f"{sf.device}"
        )
    if codes.dtype != torch.uint8:
        raise TypeError(f"{name}: codes must be uint8, got {codes.dtype}")
    xf = x.to(torch.float32).contiguous()
    c = codes.contiguous()
    out = torch.empty((x.shape[0], codes.shape[1]), dtype=torch.float32, device=x.device)
    _build.launch(name, xf, c, sf, out, nibble, fmt)
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

    Any M, K and N: the kernel masks the ragged edges, so K rows past the
    logical K (the nibble pad row) meet zero activations. ``sf`` is one
    float32 scale factor.
    """
    check_kernel_args("elp_bsd_matmul", x, codes, nibble)
    out_dtype = out_dtype or x.dtype
    sf = as_scale(sf, x.device)
    if x.device.type == "cpu":
        return elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"elp_bsd_matmul runs on cuda or cpu tensors, got {x.device}")
    out = launch_checked("elp_bsd_matmul", x, codes, sf, fmt, nibble)
    elp_bsd_matmul.launches += 1
    return out.to(out_dtype)


elp_bsd_matmul.launches = 0
