"""Plain PyTorch oracles for the ELP_BSD decode and the packed matmul.

``decode_values`` is the select-chain decoder; ``decode_values_shift_add``
builds each digit's ``±2^shift`` term in one integer construction of the
float32 sign and exponent fields, ``(shift + 127) << 23 | sign << 31``,
viewed as float32. Both are bit-identical to each other and to the JAX
package's ``kernels/ref.py``. The float32 CUDA kernels run the shift-add
form; the tensor-core kernels look each code byte up in
:func:`decode_table`, built from it, or, for a format whose values are not
all exact in bf16, build each digit's plane of terms (:func:`digit_planes`,
from :func:`plane_words`), and split float32 activations by
:func:`split_bf16x3`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat


def _exp2_int(shift: torch.Tensor) -> torch.Tensor:
    """``2.0**shift`` for integer ``shift`` via float32 exponent construction."""
    return ((shift + 127).to(torch.int32) << 23).view(torch.float32)


def decode_values(codes: torch.Tensor, fmt: ElpBsdFormat) -> torch.Tensor:
    """Decode raw codes (integer tensor) to unscaled float32 values."""
    codes = codes.to(torch.int32)
    out = torch.zeros(codes.shape, dtype=torch.float32, device=codes.device)
    for (off, sbits, ibits), tab in zip(fmt.field_layout(), fmt.shift_tables()):
        field = (codes >> off) & ((1 << (sbits + ibits)) - 1)
        idx = field & ((1 << ibits) - 1)
        shift = torch.full_like(codes, int(tab[0]))
        for e in range(1, len(tab)):
            shift = torch.where(idx == e, int(tab[e]), shift)
        mag = _exp2_int(shift)
        if sbits:
            sign = 1.0 - 2.0 * ((field >> ibits) & 1).to(torch.float32)
            out = out + sign * mag
        else:
            out = out + mag
    return out


def decode_values_shift_add(codes: torch.Tensor, fmt: ElpBsdFormat) -> torch.Tensor:
    """Shift-add decode: bit-identical to :func:`decode_values`.

    Per digit the term is the int32 bit pattern ``(shift + 127) << 23``
    with the digit's sign bit OR'd into bit 31; the shift comes from
    ``a + b * index`` for affine LUTs, else from a select chain. The
    terms (all exact) are summed in digit order.
    """
    out = None
    for term in digit_terms(codes, fmt):
        out = term if out is None else out + term
    return out


def digit_terms(codes: torch.Tensor, fmt: ElpBsdFormat) -> list[torch.Tensor]:
    """Each digit's float32 term ``±2^shift`` of every code (integer tensor), in digit order."""
    codes = codes.to(torch.int32)
    out = []
    for off, sbits, ibits, tab, affine in fmt.shift_add_decomposition():
        field = (codes >> off) & ((1 << (sbits + ibits)) - 1)
        idx = field & ((1 << ibits) - 1)
        if affine is not None:
            a, b = affine
            shift = a + idx * b if b else torch.full_like(codes, a)
        else:
            shift = torch.full_like(codes, int(tab[0]))
            for e in range(1, len(tab)):
                shift = torch.where(idx == e, int(tab[e]), shift)
        bits = (shift + 127) << 23
        if sbits:
            bits = bits | (((field >> ibits) & 1) << 31)
        out.append(bits.to(torch.int32).view(torch.float32))
    return out


@functools.lru_cache(maxsize=None)
def bf16_exact(fmt: ElpBsdFormat) -> bool:
    """Whether every decoded value of ``fmt`` is exact in bfloat16.

    Then a bfloat16 activation times a decoded weight is exact in float32,
    so a bf16 tensor-core product forms the same products as the float32
    reference. True for the four presets (at most two terms of shift 0..7:
    at most 8 significant bits); false where two terms lie more than 7
    binary places apart, e.g. shifts 0 and 9.
    """
    vals = decode_values_shift_add(torch.arange(2**fmt.bits_per_weight), fmt)
    return bool(torch.equal(vals.to(torch.bfloat16).to(torch.float32), vals))


MAX_PLANES = 3  # digits of a format the digit-plane kernels take
PLANE_WORDS = 8  # descriptor words a digit (csrc/hopper.cuh, DigitPlanes)


@functools.lru_cache(maxsize=None)
def planes_ok(fmt: ElpBsdFormat) -> bool:
    """Whether the tensor-core kernels' digit planes take ``fmt``.

    2 or 3 digits, each with at most 8 shifts (3 index bits: the kernels
    hold a digit's exponents in two registers) and every term ``±2^shift``
    a normal bf16 (shift in -126..127), in codes of at most 8 bits. Then
    ``x @ W = Σ_d x @ P_d`` with each plane ``P_d`` exact in bf16
    (:func:`digit_planes`).
    """
    dec = fmt.shift_add_decomposition()
    return (2 <= len(dec) <= MAX_PLANES and fmt.bits_per_weight <= 8
            and all(ibits <= 3 and all(-126 <= int(t) <= 127 for t in tab)
                    for _, _, ibits, tab, _ in dec))


def digit_planes(codes: torch.Tensor, fmt: ElpBsdFormat, nibble: bool = False) -> torch.Tensor:
    """The digit planes of ``codes``: bf16 ``[D, K, N]``, plane ``d`` digit ``d``'s
    term ``±2^shift`` of each code (exact in bf16 for a :func:`planes_ok`
    format). Nibble codes ``[ceil(K/2), N]`` unpack to ``2 * ceil(K/2)`` rows.
    Their float32 sum in digit order is :func:`decode_values_shift_add`, bit
    for bit. The digit-plane kernels build each term from :func:`plane_words`."""
    c = unpack_nibbles_k(codes) if nibble else codes
    return torch.stack([t.to(torch.bfloat16) for t in digit_terms(c, fmt)])


def plane_words(fmt: ElpBsdFormat) -> list[int]:
    """The digit-plane kernels' descriptor of ``fmt`` (``csrc/hopper.cuh``, DigitPlanes):
    the digit count, then :data:`PLANE_WORDS` unsigned words for each of
    :data:`MAX_PLANES` digits (zero past the last): the biased exponents
    ``127 + shift`` of the digit's shift LUT as bytes (entries 0-3, 4-7; the
    last repeated), the field's offset, the index mask in both 16-bit
    halves, the left shift taking the sign bit to bit 15 and the sign mask
    ``0x80008000`` (both 0 for an unsigned digit), one unused word. Raises
    ValueError for a format that is not :func:`planes_ok`."""
    if not planes_ok(fmt):
        raise ValueError(f"{fmt.name}: the digit-plane kernels take 2-3 digits of at most 8 "
                         "shifts each, every term a normal bf16")
    dec = fmt.shift_add_decomposition()
    words = [len(dec)]
    for off, sbits, ibits, tab, _ in dec:
        e = [int(t) + 127 for t in tab]
        e += [e[-1]] * (8 - len(e))
        lut = [sum(v << (8 * i) for i, v in enumerate(e[j:j + 4])) for j in (0, 4)]
        imask = ((1 << ibits) - 1) * 0x10001
        sign = [15 - (off + ibits), 0x80008000] if sbits else [0, 0]
        words += [*lut, off, imask, *sign, 0, 0]
    return words + [0] * (PLANE_WORDS * (MAX_PLANES - len(dec)))


def _bf16_bits(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def decode_table(fmt: ElpBsdFormat, nibble: bool) -> torch.Tensor:
    """The bf16 tensor-core kernel's decode table: int32 ``[256]``, indexed by code byte.

    Nibble: the bf16 bit patterns of the low nibble's value (the even K
    row) in bits 0-15 and the high nibble's (the odd row) in bits 16-31,
    one bf16 pair per byte. u8: the code's bf16 bit pattern in bits 0-15.
    The values are :func:`decode_values_shift_add`'s, exact in bf16, so the
    table is bit-identical to it. Raises ValueError for a format that is
    not :func:`bf16_exact` or too wide for nibble packing.
    """
    if not bf16_exact(fmt):
        raise ValueError(f"{fmt.name}: decoded values are not all exact in bfloat16")
    if nibble and fmt.bits_per_weight > 4:
        raise ValueError(f"{fmt.name} has {fmt.bits_per_weight}-bit codes; nibbles hold 4")
    byte = torch.arange(256, dtype=torch.int32)
    if not nibble:
        return _bf16_bits(decode_values_shift_add(byte, fmt))
    lo = _bf16_bits(decode_values_shift_add(byte & 0x0F, fmt))
    hi = _bf16_bits(decode_values_shift_add(byte >> 4, fmt))
    return lo | (hi << 16)


def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` (cast to float32) split exactly into three bf16 terms, ``x = hi + mid + lo``.

    By truncation: ``hi`` is x with its low 16 bits cleared, ``mid`` the
    remainder ``x - hi`` (exact) truncated the same way, ``lo`` what is left
    (exact, at most 8 significant bits). Each term is a float32 tensor whose
    values are exact in bf16, so its product with a bf16-exact weight is
    exact in float32. Exact for zero and every finite x above about 2^-110 in
    magnitude; ``hi`` never overflows to inf. The float32 routes of the
    tensor-core kernels split so (``csrc/hopper.cuh::split_bf16x3``, bit for
    bit).
    """
    x = x.to(torch.float32)
    mask = -65536  # 0xFFFF0000 as an int32
    hi = (x.view(torch.int32) & mask).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & mask).view(torch.float32)
    return hi, mid, r - mid


def elp_bsd_matmul_bf16x3(
    x: torch.Tensor,
    codes: torch.Tensor,
    sf: torch.Tensor,
    fmt: ElpBsdFormat,
    *,
    nibble: bool = False,
    terms: int = 3,
) -> torch.Tensor:
    """The bf16x3 routes' arithmetic in plain PyTorch, float32 out.

    ``x`` split by :func:`split_bf16x3`; the first ``terms`` terms each
    times the decoded weight in float32, summed in term order, then
    ``* sf``. ``terms=3`` is the kernels' function (the float32 product up
    to the order of its additions); 1 and 2 are the controls that show
    what dropping terms costs.
    """
    w = decode_values_shift_add(unpack_nibbles_k(codes) if nibble else codes, fmt)[: x.shape[1]]
    parts = split_bf16x3(x)[:terms]
    out = parts[0] @ w
    for p in parts[1:]:
        out = out + p @ w
    return out * sf.reshape(())


def elp_bsd_matmul_digits(
    x: torch.Tensor,
    codes: torch.Tensor,
    sf: torch.Tensor,
    fmt: ElpBsdFormat,
    *,
    nibble: bool = False,
    terms: int = 3,
) -> torch.Tensor:
    """The digit-plane routes' arithmetic in plain PyTorch, float32 out.

    ``x`` split by :func:`split_bf16x3` into its first ``terms`` bf16 terms
    (``terms=1`` is a bf16 x itself, the wgmma_digits route; 3 the
    bf16x3_digits route), each times each digit plane (:func:`digit_planes`)
    in float32, summed digit by digit and term by term, then ``* sf``. Every
    product is exact, so this is the float32 product of x and the exactly
    decoded weight up to the order of its additions (closer to it than the
    reference where a format's digits span more than float32's 24 bits).
    """
    planes = digit_planes(codes, fmt, nibble)[:, : x.shape[1]].to(torch.float32)
    parts = split_bf16x3(x)[:terms]
    out = None
    for p in planes:
        for t in parts:
            y = t @ p
            out = y if out is None else out + y
    return out * sf.reshape(())


def unpack_nibbles_k(packed: torch.Tensor) -> torch.Tensor:
    """``[..., K/2, N]`` uint8 (two 4-bit codes along K per byte) -> ``[..., K, N]``.

    Row ``2r`` is the low nibble, row ``2r + 1`` the high one.
    """
    p = packed.to(torch.int32)
    out = torch.stack([p & 0x0F, (p >> 4) & 0x0F], dim=-2)  # [..., K/2, 2, N]
    return out.reshape(*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])


def dequantize_ref(
    codes: torch.Tensor, sf: torch.Tensor, fmt: ElpBsdFormat, *, nibble: bool = False
) -> torch.Tensor:
    """Oracle dequantization: codes -> float32 weights ``[K, N]``."""
    if nibble:
        codes = unpack_nibbles_k(codes)
    return decode_values(codes, fmt) * sf


def elp_bsd_matmul_ref(
    x: torch.Tensor,
    codes: torch.Tensor,
    sf: torch.Tensor,
    fmt: ElpBsdFormat,
    *,
    nibble: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Oracle: ``x @ dequantize(codes)`` in float32."""
    w = dequantize_ref(codes, sf, fmt, nibble=nibble)
    return torch.matmul(x.to(torch.float32), w).to(out_dtype)
