"""Decode-step ELP_BSD decode + matmul (M <= 256): kernel, plain version, wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/fused_decode.py::fused_decode_matmul`` (body
``_fused_kernel``): the same product as the tiled kernel for the small M
of an fc layer at decode-size batch, a weight-streaming GEMV-like op.

The kernel is ``csrc/fused_decode.cu``, CUDA C++ for ``sm_90a``: one
block per 32-column output strip holding all M rows, so N spreads over
the SMs; the block loops over K, stages the x strip and the code tile in
shared memory, decodes there, and sums each output in K order in float32
registers; K is split over several blocks per strip, summed in split
order by a second pass (deterministic, no atomics), so enough blocks are
resident to hide the load latency (the kernel's source picks that split
from its own strips and occupancy). At AlexNet's fc shapes with
M = 64 it is bound by the float32 CUDA-core rate (fc0: 6.6 GFLOP, about
98 us at 67 TFLOP/s, against 25.7 MB of nibble codes, about 7.7 us at
3.35 TB/s); at the bf16 tensor-core rate the code stream would bound it.

:func:`fused_decode_matmul` takes the plain version
(:func:`fused_decode_matmul_plain`, the tiled kernel's plain version under
a second name: the product is the same) only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
``fused_decode_matmul.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.kernels.elp_bsd_matmul import as_scale, check_kernel_args, launch_checked
from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain as fused_decode_matmul_plain

# The whole M strip of one block sits in shared memory; past this, the
# tiled kernel's M tiling applies.
MAX_FUSED_M = 256


def fused_decode_matmul(
    x: torch.Tensor,
    codes: torch.Tensor,
    sf,
    fmt: ElpBsdFormat,
    *,
    nibble: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x[M, K] @ dequant(codes)[K, N]`` for decode-step M (<= MAX_FUSED_M).

    Any K and N: the kernel masks the ragged edges (the nibble pad row
    meets zero activations); M rides whole. ``sf`` is one float32 scale.
    """
    check_kernel_args("fused_decode_matmul", x, codes, nibble)
    m = x.shape[0]
    if m > MAX_FUSED_M:
        raise ValueError(
            f"fused decode kernel holds the whole M strip on chip; M={m} exceeds "
            f"{MAX_FUSED_M} — use elp_bsd_matmul for prefill-sized batches"
        )
    out_dtype = out_dtype or x.dtype
    sf = as_scale(sf, x.device)
    if x.device.type == "cpu":
        return fused_decode_matmul_plain(x, codes, sf, fmt, nibble=nibble, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_matmul runs on cuda or cpu tensors, got {x.device}")
    out = launch_checked("fused_decode", x, codes, sf, fmt, nibble)
    fused_decode_matmul.launches += 1
    return out.to(out_dtype)


fused_decode_matmul.launches = 0
