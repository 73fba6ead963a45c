"""CNNs of the paper: AlexNet, VGG-16 and their CPU-sized minis.

Activations are NHWC, conv weights HWIO ``[kh, kw, cin, cout]``, fc
weights ``[in, out]``, as in the JAX package's ``models/cnn.py``, so the
same parameter dict (carried across with
:func:`repro_torch.interop.params_from_numpy`) gives the same network.
Weights may be float tensors or :class:`~repro_torch.kernels.ops.PackedWeight`
leaves: packed convs run im2col through the packed matmul kernels, packed
fc layers through :func:`~repro_torch.kernels.ops.quantized_matmul`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantize import fake_quant_dynamic, fake_quant_uniform
from repro_torch.device import full_f32, resolve_device
from repro_torch.kernels.conv import conv2d_nhwc, quantized_conv2d
from repro_torch.kernels.ops import PackedWeight, quantized_matmul
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class Conv:
    ch: int
    k: int
    stride: int = 1


@dataclasses.dataclass(frozen=True)
class Pool:
    k: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class Fc:
    out: int


@dataclasses.dataclass(frozen=True)
class CnnSpec:
    name: str
    layers: tuple[Any, ...]
    input_hw: int
    input_ch: int = 3

    def macs(self) -> int:
        """Multiply-accumulates per inference (for the energy model)."""
        hw, ch = self.input_hw, self.input_ch
        total = 0
        for l in self.layers:
            if isinstance(l, Conv):
                hw = hw // l.stride
                total += hw * hw * l.k * l.k * ch * l.ch
                ch = l.ch
            elif isinstance(l, Pool):
                hw = hw // l.stride
            elif isinstance(l, Fc):
                total += (hw * hw * ch if hw else ch) * l.out
                hw = 0
                ch = l.out
        return total


ALEXNET = CnnSpec(
    "alexnet",
    (
        Conv(96, 11, 4),
        Pool(),
        Conv(256, 5),
        Pool(),
        Conv(384, 3),
        Conv(384, 3),
        Conv(256, 3),
        Pool(),
        Fc(4096),
        Fc(4096),
        Fc(1000),
    ),
    input_hw=224,
)

VGG16 = CnnSpec(
    "vgg16",
    (
        Conv(64, 3), Conv(64, 3), Pool(),
        Conv(128, 3), Conv(128, 3), Pool(),
        Conv(256, 3), Conv(256, 3), Conv(256, 3), Pool(),
        Conv(512, 3), Conv(512, 3), Conv(512, 3), Pool(),
        Conv(512, 3), Conv(512, 3), Conv(512, 3), Pool(),
        Fc(4096), Fc(4096), Fc(1000),
    ),
    input_hw=224,
)

# CPU-sized variants (same family shape, same code paths).
ALEXNET_MINI = CnnSpec(
    "alexnet_mini",
    (Conv(16, 5, 2), Pool(), Conv(32, 3), Pool(), Conv(32, 3), Fc(128), Fc(10)),
    input_hw=32,
)
VGG_MINI = CnnSpec(
    "vgg_mini",
    (Conv(16, 3), Conv(16, 3), Pool(), Conv(32, 3), Conv(32, 3), Pool(), Fc(128), Fc(10)),
    input_hw=32,
)


def init_params(spec: CnnSpec, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Seeded random parameters in the JAX package's layout and scale.

    The numbers differ from the JAX package's (another generator); the
    shapes, names and distributions are the same. Made on the host from a
    ``torch.Generator`` and moved to ``device`` (default: the card).
    """
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: dict[str, torch.Tensor] = {}
    ch = spec.input_ch
    hw = spec.input_hw
    idx = 0
    flat: int | None = None
    for l in spec.layers:
        if isinstance(l, Conv):
            params[f"conv{idx}_w"] = dense_init(
                gen, (l.k, l.k, ch, l.ch), dtype, device=device
            ) * float(np.sqrt(1.0 / (l.k * l.k)))
            params[f"conv{idx}_b"] = torch.zeros((l.ch,), dtype=dtype, device=device)
            ch = l.ch
            hw = hw // l.stride
            idx += 1
        elif isinstance(l, Pool):
            hw = hw // l.stride
        elif isinstance(l, Fc):
            fan_in = flat if flat is not None else hw * hw * ch
            params[f"fc{idx}_w"] = dense_init(gen, (fan_in, l.out), dtype, device=device)
            params[f"fc{idx}_b"] = torch.zeros((l.out,), dtype=dtype, device=device)
            flat = l.out
            idx += 1
    return params


def forward(
    params: dict,
    spec: CnnSpec,
    x: torch.Tensor,
    act_bits: int | None = None,
    *,
    calib=None,
    tap=None,
    impl: str = "auto",
    block_sizes: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """``x[B, H, W, C]`` images -> logits ``[B, n_classes]``.

    Activation quantization by site (``"input"``, then ``"conv{i}"`` /
    ``"fc{i}"`` after each hidden relu): ``act_bits`` alone quantizes with
    a dynamic per-tensor range; ``calib`` (a
    :class:`~repro_torch.calib.policy.CalibrationTable`) with static
    per-site scales, ``act_bits`` then overriding its bit-width. ``tap`` is
    called as ``x = tap(site, x)`` on the pre-quantization value at every
    site. Packed weights run on the kernels through ``impl``; float weights
    take ``F.conv2d`` / ``torch.matmul`` in full float32.
    """

    def q(t, site):
        if tap is not None:
            t = tap(site, t)
        if calib is not None:
            sc = calib.site(site)
            return fake_quant_uniform(t, act_bits or sc.bits, sc.amax)
        return fake_quant_dynamic(t, act_bits) if act_bits else t

    idx = 0
    flat = False
    n_layers = sum(isinstance(l, (Conv, Fc)) for l in spec.layers)
    with full_f32():
        x = q(x.to(torch.float32), "input")
        for l in spec.layers:
            if isinstance(l, Conv):
                w = params[f"conv{idx}_w"]
                if isinstance(w, PackedWeight):
                    x = quantized_conv2d(
                        x, w, stride=l.stride, padding="SAME", impl=impl,
                        block_sizes=block_sizes, out_dtype=torch.float32,
                    )
                else:
                    x = conv2d_nhwc(x, w.to(torch.float32), stride=l.stride, padding="SAME")
                x = x + params[f"conv{idx}_b"].to(torch.float32)
                x = q(torch.relu(x), f"conv{idx}")
                idx += 1
            elif isinstance(l, Pool):
                # reduce_window max, VALID: floor((H - k) / s) + 1 windows
                x = F.max_pool2d(x.permute(0, 3, 1, 2), l.k, l.stride).permute(0, 2, 3, 1)
            elif isinstance(l, Fc):
                if not flat:
                    x = x.reshape(x.shape[0], -1)
                    flat = True
                w = params[f"fc{idx}_w"]
                if isinstance(w, PackedWeight):
                    x = quantized_matmul(
                        x, w, impl=impl, block_sizes=block_sizes, out_dtype=torch.float32
                    )
                else:
                    x = torch.matmul(x, w.to(torch.float32))
                x = x + params[f"fc{idx}_b"].to(torch.float32)
                idx += 1
                if idx < n_layers:
                    x = q(torch.relu(x), f"fc{idx - 1}")
    return x

