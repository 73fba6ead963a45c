"""Decode-step ELP_BSD decode + matmul (M <= 256): the kernels, the plain version, the wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/fused_decode.py::fused_decode_matmul`` (body
``_fused_kernel``): the same product as the tiled kernel for the small M
of an fc layer or an LM decode step, a weight-streaming GEMV-like op.

Three routes, each its own CUDA C++ kernel for ``sm_90a``; :func:`route`
(the tiled kernel's rule, :func:`repro_torch.kernels.elp_bsd_matmul.route`)
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
* ``"f32"`` (``csrc/fused_decode.cu``): a format that is not bf16-exact (or
  an x of another type), cast to float32, on CUDA cores: one block per
  32-column output strip holding all M rows, a K loop that stages the x
  strip and the code tile in shared memory and decodes there, K split over
  blocks and summed in split order by a second pass.

All three are deterministic: no atomics touch the sums. A failed build
or launch raises: nothing retries on another route.

:func:`fused_decode_matmul` takes the plain version
(:func:`fused_decode_matmul_plain`, the tiled kernel's plain version under
a second name: the product is the same) only for tensors on the CPU; on a
CUDA tensor it launches the routed kernel or raises.
``fused_decode_matmul.launches`` counts every route's launches and
``fused_decode_matmul.launches_by_route[route]`` each one's. An input
that requires grad, with grad mode on, raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.kernels.elp_bsd_matmul import (
    ROUTES,
    as_scale,
    check_kernel_args,
    launch_checked,
    launch_wgmma,
    refuse_grad,
    route,
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
    check_kernel_args("fused_decode_matmul", x, codes, nibble)
    refuse_grad("fused_decode_matmul", x)
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
    r = route(x, fmt)
    if r in ("wgmma", "bf16x3"):
        out = launch_wgmma(x, codes, sf, fmt, nibble, name="fused_decode_wgmma", route=r)
    else:
        out = launch_checked("fused_decode", x, codes, sf, fmt, nibble)
    fused_decode_matmul.launches += 1
    fused_decode_matmul.launches_by_route[r] += 1
    return out.to(out_dtype)


fused_decode_matmul.launches = 0
fused_decode_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
