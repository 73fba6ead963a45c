"""Packed ELP_BSD weights and the matmul front door over the two kernels.

``PackedWeight`` is the artifact of conversion: a uint8 code buffer
(nibble-packed along K for 4-bit formats), keepdims-broadcastable float32
scale factors, and the format's name and logical shape. Conversion runs
through :func:`repro_torch.core.convert.convert_tensor`; conv weights pack
to the ``[kh*kw*cin, cout]`` im2col layout (:func:`pack_conv_weight`).

:func:`quantized_matmul` keeps the JAX package's wrapper contracts
(``repro/kernels/ops.py``): a static ``act_scale`` fake-quant first, the
nibble pad row fed zero activations, a per-channel ``sf`` applied after
the kernel, and ``ValueError`` on a bad block tuple or an odd nibble
``block_k``. Where the JAX wrapper pads M, K and N to the tiles, the CUDA
kernels mask those edges instead, so nothing is copied to pad them. Its
``impl`` picks the kernel: ``"auto"`` takes the decode-step kernel for
M <= 256 and the tiled kernel above, ``"tiled"`` and ``"fused"`` force one.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.convert import convert_tensor, nibble_pack
from repro_torch.core.elp_bsd import ElpBsdFormat, resolve_format
from repro_torch.core.quantize import fake_quant_uniform
from repro_torch.kernels import ref as kref
from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
from repro_torch.kernels.fused_decode import MAX_FUSED_M, fused_decode_matmul

IMPLS = ("auto", "tiled", "fused")


@dataclasses.dataclass
class PackedWeight:
    """ELP_BSD-encoded weight matrix ``[K, N]``, or a stack of them.

    Attributes:
      codes: uint8 ``[K, N]`` (u8 mode) or ``[ceil(K/2), N]`` (nibble mode),
        with a leading layer axis ``[L, K', N]`` for a stacked LM leaf, and
        layer and expert axes ``[L, E, K', N]`` for an MoE expert stack.
      sf: float32 scale factors, ``[1, 1]`` per tensor or ``[1, N]`` per
        output channel; ``[L, 1, 1]`` (``[L, E, 1, 1]``) per slice of a stack.
      fmt_name: a preset format name.
      nibble: whether codes are nibble-packed along K.
      shape: logical ``(K, N)``.
      source_shape: ``(kh, kw, cin, cout)`` for a conv weight, else None.
      act_scale / act_bits: an optional static quantizer for this weight's
        input, applied by :func:`quantized_matmul` before the product.
    """

    codes: torch.Tensor
    sf: torch.Tensor
    fmt_name: str
    nibble: bool
    shape: tuple[int, int]
    source_shape: tuple[int, ...] | None = None
    act_scale: float | None = None
    act_bits: int | None = None

    @property
    def fmt(self) -> ElpBsdFormat:
        return resolve_format(self.fmt_name)

    @property
    def nbytes(self) -> int:
        return self.codes.numel()

    def to(self, device) -> "PackedWeight":
        return dataclasses.replace(self, codes=self.codes.to(device), sf=self.sf.to(device))

    @property
    def n_layers(self) -> int | None:
        """Layers of a stacked leaf (codes ``[L, K', N]`` or ``[L, E, K', N]``), None for
        one matrix."""
        return self.codes.shape[0] if self.codes.ndim >= 3 else None

    def layer(self, i: int) -> "PackedWeight":
        """Layer ``i`` of a stacked leaf, sharing storage (no copy).

        An ``[L, K', N]`` leaf gives one ``[K', N]`` weight (``sf`` its one
        element), which goes through :func:`quantized_matmul` like any single
        weight; an ``[L, E, K', N]`` expert stack gives the layer's
        ``[E, K', N]`` stack (``sf`` ``[E, 1, 1]``), which :func:`dequantize`
        decodes whole.
        """
        if self.codes.ndim not in (3, 4):
            raise ValueError(f"layer() slices a stacked [L, K', N] or [L, E, K', N] leaf; "
                             f"codes are {tuple(self.codes.shape)}")
        return dataclasses.replace(self, codes=self.codes[i], sf=self.sf[i])


def pack_weight(
    w: torch.Tensor,
    fmt: "ElpBsdFormat | str",
    *,
    compensate: bool = True,
    group_axes: Sequence[int] | None = None,
    granularity: str = "per_tensor",
    nibble: bool | None = None,
) -> tuple[PackedWeight, torch.Tensor]:
    """A ``[K, N]`` weight -> (packed codes, dequantized values).

    Algorithm 1 groups the contracting rows of each output column by
    default; 4-bit formats nibble-pack along K (odd K pads one code row).
    """
    fmt = resolve_format(fmt)
    if w.ndim != 2:
        raise ValueError(f"pack_weight operates on [K, N] matmul weights, got shape {tuple(w.shape)}")
    if nibble is None:
        nibble = fmt.bits_per_weight <= 4
    ct = convert_tensor(
        w, fmt, granularity=granularity, compensate=compensate,
        group_axes=group_axes if group_axes is not None else (0,),
    )
    codes = ct.codes()
    if nibble:
        codes = nibble_pack(codes, axis=-2)
    pw = PackedWeight(
        codes=codes, sf=ct.sf, fmt_name=fmt.name, nibble=bool(nibble),
        shape=(int(w.shape[0]), int(w.shape[1])),
    )
    return pw, ct.values.to(w.dtype)


def pack_conv_weight(
    w: torch.Tensor,
    fmt: "ElpBsdFormat | str",
    *,
    compensate: bool = True,
    granularity: str = "per_tensor",
    nibble: bool | None = None,
) -> tuple[PackedWeight, torch.Tensor]:
    """A conv ``[kh, kw, cin, cout]`` weight -> im2col-packed codes ``[kh*kw*cin, cout]``.

    Quantization and Algorithm 1 (groups = the spatial dims) run on the
    conv layout. Returns the packed weight and the dequantized values in
    conv layout.
    """
    fmt = resolve_format(fmt)
    if w.ndim != 4:
        raise ValueError(
            f"pack_conv_weight operates on [kh, kw, cin, cout] weights, got shape {tuple(w.shape)}"
        )
    if granularity == "per_slice":
        raise ValueError("per_slice granularity is for stacked matmuls, not convs")
    if nibble is None:
        nibble = fmt.bits_per_weight <= 4
    ct = convert_tensor(w, fmt, granularity=granularity, compensate=compensate, group_axes=(0, 1))
    kh, kw, cin, cout = w.shape
    codes = ct.codes().reshape(kh * kw * cin, cout)
    if nibble:
        codes = nibble_pack(codes, axis=-2)
    pw = PackedWeight(
        codes=codes,
        sf=ct.sf.reshape(1, -1),  # sf varies along cout at most
        fmt_name=fmt.name,
        nibble=bool(nibble),
        shape=(kh * kw * cin, cout),
        source_shape=(kh, kw, cin, cout),
    )
    return pw, ct.values.to(w.dtype)


def tree_leaves(tree) -> list:
    """The leaves of a (nested) params dict, PackedWeights whole, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a (nested) params dict, PackedWeights whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def packed_tree_bytes(tree: dict, *, packed_only: bool = False) -> int:
    """Weight-storage bytes of a (nested) params dict: codes plus float32 scales
    per PackedWeight (stacked leaves whole), ``numel * itemsize`` for other
    tensors unless ``packed_only``."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, PackedWeight):
            total += leaf.nbytes + leaf.sf.numel() * 4
        elif not packed_only:
            total += leaf.numel() * leaf.element_size()
    return total


def _decode(pw: PackedWeight, decoder) -> torch.Tensor:
    codes = kref.unpack_nibbles_k(pw.codes) if pw.nibble else pw.codes
    return (decoder(codes, pw.fmt) * pw.sf)[..., : pw.shape[0], : pw.shape[1]]


def dequantize(pw: PackedWeight) -> torch.Tensor:
    """Decode a PackedWeight to float32 ``[..., K, N]`` (select-chain decoder)."""
    return _decode(pw, kref.decode_values)


def dequantize_shift_add(pw: PackedWeight) -> torch.Tensor:
    """Decode via the shift-add decomposition: bit-identical to :func:`dequantize`."""
    return _decode(pw, kref.decode_values_shift_add)


def dequantize_nd(pw: PackedWeight) -> torch.Tensor:
    """Decode to the source layout (conv ``[kh, kw, cin, cout]``)."""
    w = dequantize(pw)
    return w.reshape(pw.source_shape) if pw.source_shape is not None else w


def dequantize_tree(tree: dict) -> dict:
    """Every PackedWeight of a (nested) params dict decoded to float32 (source layouts)."""
    return tree_map(lambda v: dequantize_nd(v) if isinstance(v, PackedWeight) else v, tree)


def quantized_matmul(
    x: torch.Tensor,
    pw: PackedWeight,
    *,
    impl: str = "auto",
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    block_sizes: tuple[int, int, int] | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x[..., K] @ dequant(pw)[K, N]`` on the codes, through one of the two kernels.

    ``block_sizes`` overrides the ``block_*`` arguments with a
    ``(block_m, block_n, block_k)`` tuple. They are the JAX package's
    tiling arguments, checked as there; the CUDA kernels pick their own
    tiles and mask the ragged edges.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; pick from {IMPLS}")
    if pw.act_scale is not None:
        x = fake_quant_uniform(x, pw.act_bits or 8, pw.act_scale)
    k, n = pw.shape
    if x.shape[-1] != k:
        raise ValueError(f"x[..., {x.shape[-1]}] does not match the packed weight's K={k}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m0 = x2.shape[0]
    out_dtype = out_dtype or x.dtype
    if block_sizes is not None:
        if isinstance(block_sizes, tuple) and len(block_sizes) == 3:
            block_m, block_n, block_k = block_sizes
        else:
            raise ValueError(
                f"block_sizes must be a (block_m, block_n, block_k) tuple or None; "
                f"got {block_sizes!r}"
            )
    if min(block_m, block_n, block_k) <= 0:
        raise ValueError(f"block sizes must be positive; got {(block_m, block_n, block_k)}")
    if pw.nibble and block_k % 2 != 0:
        raise ValueError(
            f"nibble-packed weights need an even block_k (two codes per byte along K); "
            f"got block_k={block_k} for weight {pw.shape} fmt={pw.fmt_name}"
        )
    if pw.codes.ndim != 2:
        raise ValueError(
            "quantized_matmul takes a single [K, N] weight; slice a stacked leaf with "
            "PackedWeight.layer(i)"
        )
    if impl == "auto":
        impl = "fused" if m0 <= MAX_FUSED_M else "tiled"
    # No padding: the kernels mask ragged M, N and K, so K rows past the
    # logical K (the nibble pad row, whose code decodes to a nonzero
    # value) meet zero activations there.
    # A per-channel sf scales output columns, so it factors out of the
    # product: the kernel runs unscaled and sf applies to its output.
    per_channel = pw.sf.numel() > 1
    sf_kernel = torch.ones(1, dtype=torch.float32, device=x.device) if per_channel else pw.sf
    kernel = fused_decode_matmul if impl == "fused" else elp_bsd_matmul
    out = kernel(x2, pw.codes, sf_kernel, pw.fmt, nibble=pw.nibble, out_dtype=torch.float32)
    if per_channel:
        out = out * pw.sf.reshape(1, n)
    return out.to(out_dtype).reshape(*lead, n)
