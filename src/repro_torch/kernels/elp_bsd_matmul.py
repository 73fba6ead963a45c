"""Tiled ELP_BSD decode + matmul: the Hopper kernels, their plain version, the wrapper.

Replaces the JAX package's Pallas TPU kernel
``repro/kernels/elp_bsd_matmul.py::elp_bsd_matmul`` (body ``_mm_kernel``):
``out[M, N] = (x[M, K] @ decode(codes)[K, N]) * sf`` with codes uint8
``[K, N]`` or nibble-packed ``[K/2, N]`` (low nibble = even row) and one
float32 scale factor.

Five routes, each a CUDA C++ kernel for ``sm_90a``; :func:`route` picks one
before any launch, by one rule:

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
* ``"wgmma_digits"`` and ``"bf16x3_digits"`` (the Dec = DigitPlanes
  instances of the same two kernels): bf16 x, and float32 or float16 x, with
  a format that is not bf16-exact but whose 2 or 3 digit terms ``±2^shift``
  are normal bf16 values (:func:`repro_torch.kernels.ref.planes_ok`; a
  user's own ``ElpBsdFormat`` such as a second digit reaching ``2^9``). The
  product is ``Σ_d x @ P_d`` over the digit planes
  (:func:`repro_torch.kernels.ref.digit_planes`), each plane decoded from
  the codes in registers and run on the tensor cores like the table's one
  plane: every product is exact, so again only the order of the float32
  sums differs.
* ``"f32"`` (``csrc/elp_bsd_matmul.cu``): any other format (4 or more
  digits, terms outside bf16's normal range) or an x of another type, x
  cast to float32, on CUDA cores: a 128 x 128 output tile per block, a K
  loop inside the block, x and code tiles staged and decoded (shift-add) in
  shared memory, an 8 x 8 float32 micro-tile per thread, capped at the
  H100's CUDA-core rate (67 TFLOP/s).

TMA needs a 16-byte aligned base and row stride: x or codes without them
are first copied once into a buffer with padded rows. An x that is a
row-strided view with such rows goes as it is: ``kernels/conv.py`` writes
the im2col patches so, for conv0's K = 363.

All of them mask ragged edges and split K over several blocks per tile
(summed by a deterministic second pass) where the tiles alone would leave
SMs idle in the last wave; each kernel picks that split from its own
tiles and occupancy. The decoded weight never reaches device memory. A failed
build or launch raises: nothing retries on another route.

:func:`elp_bsd_matmul` takes the plain version (:func:`elp_bsd_matmul_plain`)
only for tensors on the CPU; on a CUDA tensor it launches the routed kernel
or raises. ``elp_bsd_matmul.launches`` counts every route's launches and
``elp_bsd_matmul.launches_by_route[route]`` each one's: real launches only.
An input that requires grad, with grad mode on, raises (:func:`refuse_grad`).

A ``meta`` x (the dry-run's abstract evaluation,
:mod:`repro_torch.launch.hlo_stats`) is counted, never computed: the wrapper
returns an empty ``meta`` ``[M, N]`` of ``out_dtype`` and launches nothing, so
no value comes out that a caller could take for a result. Under an active
cost counter (:mod:`repro_torch.runtime.cost`) every call, on any device,
counts as one operation: ``2·M·K·N`` FLOPs and the bytes of x, the codes, the
scale factor and the float32 output, each once, under the route that a CUDA
x of its dtype takes (``"plain"`` on the CPU). What runs inside is not
counted on top of it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.runtime import cost
from repro_torch.kernels.ref import (
    bf16_exact,
    decode_table,
    decode_values_shift_add,
    plane_words,
    planes_ok,
    unpack_nibbles_k,
)

ROUTES = ("wgmma", "bf16x3", "wgmma_digits", "bf16x3_digits", "f32")
# The tensor-core routes, by the x dtypes each takes.
TENSOR_CORE_DTYPES = {"wgmma": (torch.bfloat16,), "bf16x3": (torch.float32, torch.float16)}


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
    """The kernel :func:`elp_bsd_matmul` launches for a CUDA ``x``: ``"wgmma"``
    for bf16 ``x`` and ``"bf16x3"`` for float32 or float16 ``x`` with a
    :func:`~repro_torch.kernels.ref.bf16_exact` format (every preset); the
    same with ``"_digits"`` for a format the digit planes take
    (:func:`~repro_torch.kernels.ref.planes_ok`); else ``"f32"``."""
    tc = next((r for r, dtypes in TENSOR_CORE_DTYPES.items() if x.dtype in dtypes), None)
    if tc is None:
        return "f32"
    if bf16_exact(fmt):
        return tc
    return tc + "_digits" if planes_ok(fmt) else "f32"


def device_route(name: str, x: torch.Tensor, fmt: ElpBsdFormat) -> str:
    """``"plain"`` for a CPU x; :func:`route`'s for a CUDA or ``meta`` one (a meta
    call counts under the route a CUDA x of its dtype takes). Any other device
    raises."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on cuda or cpu tensors (or meta, counted only), "
                         f"got {x.device}")
    with cost.paused():  # the format's table check is no part of the call's cost
        return route(x, fmt)


def count_matmul(name: str, r: str, x: torch.Tensor, codes: torch.Tensor,
                 out: torch.Tensor) -> None:
    """Report one packed-matmul call to the active cost counter (nothing to do
    without one)."""
    if cost.active() is None:
        return
    m, kdim = x.shape
    n = out.shape[1]
    cost.kernel(name, r, 2.0 * m * kdim * n, cost.matmul_bytes(x, codes, m, n), out)


@functools.lru_cache(maxsize=None)
def _table_words(fmt: ElpBsdFormat, nibble: bool) -> ctypes.Array:
    """:func:`decode_table` as the 256 unsigned words the wgmma kernel's entry point reads."""
    return (ctypes.c_uint32 * 256)(*(v & 0xFFFFFFFF for v in decode_table(fmt, nibble).tolist()))


@functools.lru_cache(maxsize=None)
def _plane_words(fmt: ElpBsdFormat) -> ctypes.Array:
    """:func:`plane_words` as the unsigned words the digit routes' entry points read."""
    words = plane_words(fmt)
    return (ctypes.c_uint32 * len(words))(*words)


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
    ``"wgmma"`` and ``"wgmma_digits"`` on bf16 ``x`` as it is, ``"bf16x3"``
    and ``"bf16x3_digits"`` on float32 or float16 ``x`` as float32, the
    ``"_digits"`` routes on the format's digit planes; float32 ``[M, N]`` out."""
    from repro_torch import _build

    _check_operands(name, x, codes, sf)
    base = route.removesuffix("_digits")
    if x.dtype not in TENSOR_CORE_DTYPES[base]:
        takes = " or ".join(str(d)[6:] for d in TENSOR_CORE_DTYPES[base])
        raise TypeError(f"the {route} route takes {takes} x, got {x.dtype}")
    if base == "bf16x3":
        x = x.to(torch.float32)
    words = _plane_words(fmt) if route != base else _table_words(fmt, nibble)
    kind = ("bf16" if base == "wgmma" else "bf16x3") + route[len(base):]
    out = torch.empty((x.shape[0], codes.shape[1]), dtype=torch.float32, device=x.device)
    _build.launch_tensor_core(name, kind, _tma_rows(x), x.shape[1], _tma_rows(codes), sf, out,
                              nibble, words)
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
    n = check_kernel_args("elp_bsd_matmul", x, codes, nibble)
    refuse_grad("elp_bsd_matmul", x)
    out_dtype = out_dtype or x.dtype
    r = device_route("elp_bsd_matmul", x, fmt)
    with cost.paused():
        sf = as_scale(sf, x.device)
        if r == "plain":
            out = elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble, out_dtype=out_dtype)
        elif x.is_meta:
            out = torch.empty((x.shape[0], n), dtype=out_dtype, device="meta")
        else:
            if r == "f32":
                out = launch_checked("elp_bsd_matmul", x, codes, sf, fmt, nibble)
            else:
                out = launch_wgmma(x, codes, sf, fmt, nibble, route=r)
            elp_bsd_matmul.launches += 1
            elp_bsd_matmul.launches_by_route[r] += 1
            out = out.to(out_dtype)
    count_matmul("elp_bsd_matmul", r, x, codes, out)
    return out


elp_bsd_matmul.launches = 0
elp_bsd_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
