"""Decode-step ELP_BSD decode + matmul (M <= 256): the kernels, the plain version, the wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/fused_decode.py::fused_decode_matmul`` (body
``_fused_kernel``): the same product as the tiled kernel for the small M
of an fc layer or an LM decode step, a weight-streaming GEMV-like op.

Five routes, each a CUDA C++ kernel for ``sm_90a``; :func:`route` (the
tiled kernel's rule, :func:`repro_torch.kernels.elp_bsd_matmul.route`)
picks one before any launch:

* ``"wgmma"`` (``csrc/fused_decode_wgmma.cu``): bf16 x and a bf16-exact
  format. x goes to the kernel as it is; the product runs transposed on
  the tensor cores (``wgmma`` with the table-decoded weight as the register
  operand and x, fed by TMA, as the shared-memory operand at N = M rounded
  up to 16, 32, 64, 128 or 256), persistent blocks walk (column strip, K
  split) items through a deep TMA ring, and the last split of a strip to
  finish adds the partial sums in split order, in the same launch. The LM
  decode step runs here, bound by its code stream.
* ``"bf16x3"`` (the same source): float32 or float16 x (as float32) and a
  bf16-exact format. A first launch splits x exactly into three bf16 terms
  (:func:`repro_torch.kernels.ref.split_bf16x3`, ``[3, M, K]``), then the
  same kernel walks its K stages in threes, one term each, and runs the
  three terms' wgmmas on A fragments decoded once per K block into one
  float32 accumulator. AlexNet's fc layers (M = 64) run here.
* ``"wgmma_digits"`` and ``"bf16x3_digits"`` (the Dec = DigitPlanes
  instances of the same kernel): a format that is not bf16-exact but whose
  2 or 3 digit terms are normal bf16 values. Each K block's codes are
  decoded once per digit into that digit's plane of A fragments, and each
  plane runs the block's wgmmas (:func:`repro_torch.kernels.ref.digit_planes`).
* ``"f32"`` (``csrc/fused_decode.cu``): any other format (4 or more digits,
  terms outside bf16's normal range) or an x of another type, cast to
  float32, on CUDA cores: one block per
  32-column output strip holding all M rows, a K loop that stages the x
  strip and the code tile in shared memory and decodes there, K split over
  blocks and summed in split order by a second pass.

All are deterministic: no atomics touch the sums. A failed build
or launch raises: nothing retries on another route.

:func:`fused_decode_matmul` takes the plain version
(:func:`fused_decode_matmul_plain`, the tiled kernel's plain version under
a second name: the product is the same) only for tensors on the CPU; on a
CUDA tensor it launches the routed kernel or raises.
``fused_decode_matmul.launches`` counts every route's launches and
``fused_decode_matmul.launches_by_route[route]`` each one's: real launches
only. An input that requires grad, with grad mode on, raises.

A ``meta`` x is counted, never computed, as in the tiled kernel's wrapper:
an empty ``meta`` ``[M, N]`` of ``out_dtype`` comes back and nothing
launches. Under an active cost counter each call is one operation of
``2·M·K·N`` FLOPs and the bytes of x, codes, scale factor and float32 output
(:mod:`repro_torch.runtime.cost`), on every device alike.
"""
from __future__ import annotations

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.runtime import cost
from repro_torch.kernels.elp_bsd_matmul import (
    ROUTES,
    as_scale,
    check_kernel_args,
    count_matmul,
    device_route,
    launch_checked,
    launch_wgmma,
    refuse_grad,
    route,  # noqa: F401  (the tiled kernel's rule is this kernel's: fused_decode.route)
)
from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain as fused_decode_matmul_plain

# The whole M strip of one block sits on chip; past this, the tiled
# kernel's M tiling applies.
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

    Any K and N: the kernels mask the ragged edges (the nibble pad row
    meets zero activations); M rides whole. ``sf`` is one float32 scale.
    On the card the kernel is :func:`route`'s.
    """
    n = check_kernel_args("fused_decode_matmul", x, codes, nibble)
    refuse_grad("fused_decode_matmul", x)
    m = x.shape[0]
    if m > MAX_FUSED_M:
        raise ValueError(
            f"fused decode kernel holds the whole M strip on chip; M={m} exceeds "
            f"{MAX_FUSED_M} — use elp_bsd_matmul for prefill-sized batches"
        )
    out_dtype = out_dtype or x.dtype
    r = device_route("fused_decode_matmul", x, fmt)
    with cost.paused():
        sf = as_scale(sf, x.device)
        if r == "plain":
            out = fused_decode_matmul_plain(x, codes, sf, fmt, nibble=nibble,
                                            out_dtype=out_dtype)
        elif x.is_meta:
            out = torch.empty((m, n), dtype=out_dtype, device="meta")
        else:
            if r == "f32":
                out = launch_checked("fused_decode", x, codes, sf, fmt, nibble)
            else:
                out = launch_wgmma(x, codes, sf, fmt, nibble, name="fused_decode_wgmma",
                                   route=r)
            fused_decode_matmul.launches += 1
            fused_decode_matmul.launches_by_route[r] += 1
            out = out.to(out_dtype)
    count_matmul("fused_decode_matmul", r, x, codes, out)
    return out


fused_decode_matmul.launches = 0
fused_decode_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
