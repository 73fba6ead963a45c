"""Packed 2-D convolution: im2col patches into the packed matmul kernels.

Activations are NHWC and the weight is packed ``[kh*kw*cin, cout]``
(:func:`repro_torch.kernels.ops.pack_conv_weight`). Patches are ordered
``(kh, kw, cin)`` with ``cin`` fastest, the row-major flattening of an
HWIO weight, so ``patches @ w.reshape(kh*kw*cin, cout)`` is the conv.

Padding follows XLA: ``SAME`` splits an odd total pad with the extra row
or column at the end (AlexNet's 11x11 stride-4 conv on 224 pads (3, 4)),
which ``F.conv2d(padding=...)`` cannot express, so pads are explicit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import full_f32
from repro_torch.kernels.ops import PackedWeight, quantized_matmul


def _out_size_and_pads(size: int, k: int, stride: int, padding: str) -> tuple[int, tuple[int, int]]:
    """Output length and (lo, hi) pads for one spatial dim (XLA semantics)."""
    if padding == "SAME":
        out = -(-size // stride)  # ceil
        total = max((out - 1) * stride + k - size, 0)
        return out, (total // 2, total - total // 2)
    if padding == "VALID":
        return (size - k) // stride + 1, (0, 0)
    raise ValueError(f"unknown padding {padding!r}")


def pad_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str) -> torch.Tensor:
    """Pad ``x[B, H, W, C]`` spatially as XLA's ``padding`` would for this window."""
    _, (pt, pb) = _out_size_and_pads(x.shape[1], kh, stride, padding)
    _, (pl, pr) = _out_size_and_pads(x.shape[2], kw, stride, padding)
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def extract_patches(
    x: torch.Tensor, kh: int, kw: int, *, stride: int = 1, padding: str = "SAME"
) -> torch.Tensor:
    """``x[B, H, W, C]`` -> patches ``[B, Ho, Wo, kh*kw*C]`` in ``(kh, kw, C)`` order.

    The patch rows lie a multiple of 16 bytes apart, as the matmul kernels'
    TMA loads read them: where ``kh*kw*C`` elements are not (AlexNet's conv0,
    K = 363), the result is a view of a buffer with padded rows, which the
    kernels take without a copy (they read K columns of each row).
    """
    b, h, w, c = x.shape
    ho, _ = _out_size_and_pads(h, kh, stride, padding)
    wo, _ = _out_size_and_pads(w, kw, stride, padding)
    xp = pad_nhwc(x, kh, kw, stride, padding)
    # unfold -> [B, Ho', Wo', C, kh, kw]; keep the first Ho x Wo windows
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)[:, :ho, :wo]
    k = kh * kw * c
    per_row = 16 // x.element_size()
    kp = -(-k // per_row) * per_row
    patches = torch.empty((b, ho, wo, kp), dtype=x.dtype, device=x.device)[..., :k]
    patches.view(b, ho, wo, kh, kw, c).copy_(win.permute(0, 1, 2, 4, 5, 3))
    return patches


def quantized_conv2d(
    x: torch.Tensor,
    pw: PackedWeight,
    *,
    stride: int = 1,
    padding: str = "SAME",
    impl: str = "auto",
    block_sizes: tuple[int, int, int] | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``conv2d(x[B, H, W, Cin], pw)`` -> ``[B, Ho, Wo, Cout]`` on packed codes.

    ``pw`` must come from :func:`~repro_torch.kernels.ops.pack_conv_weight`.
    The im2col matmul goes through :func:`quantized_matmul` with ``impl``
    (``"auto"``: the decode-step kernel for ``B*Ho*Wo <= 256``, else tiled).
    """
    if pw.source_shape is None or len(pw.source_shape) != 4:
        raise ValueError("quantized_conv2d needs a pack_conv_weight-packed weight")
    kh, kw, _, _ = pw.source_shape
    patches = extract_patches(x.to(torch.float32), kh, kw, stride=stride, padding=padding)
    return quantized_matmul(
        patches, pw, impl=impl, block_sizes=block_sizes, out_dtype=out_dtype or x.dtype
    )


def conv2d_nhwc(
    x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: str = "SAME"
) -> torch.Tensor:
    """Float conv of ``x[B, H, W, Cin]`` with an HWIO weight, XLA padding, NHWC out.

    The float path outside any kernel (``lax.conv_general_dilated`` in the
    JAX package); on the card cuDNN's TF32 is switched off for the call.
    """
    kh, kw = w.shape[0], w.shape[1]
    xp = pad_nhwc(x, kh, kw, stride, padding).permute(0, 3, 1, 2)
    with full_f32():
        out = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1)
