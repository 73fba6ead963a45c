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
:func:`split_bf16x3`. :func:`flash_attention_bf16x3` models the float32
flash-attention route's arithmetic (both operands of each product split so).
"""
from __future__ import annotations

import functools
import math

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


# The cross-products of two operands split by split_bf16x3, (term of the
# left operand, term of the right), in the order the bf16x3 flash route
# takes them: hi.hi, then the pairs of exponent sum 1, then 2. A product
# q_i k_j is about 2^-8 (i + j) of q k; the first six are those with
# i + j <= 2, and what they drop is about 2^-21 of each product.
FLASH_PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
FLASH_BLOCK_K = 64  # keys a step of the route's online softmax
# The kernel's (S, P V) product counts: the fewest whose worst error stays
# under half the float32 limit (tests/test_torch_flash_bf16x3.py).
FLASH_ROUTE_PRODUCTS = (6, 5)


def flash_attention_bf16x3(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    products: int | tuple[int, int] = FLASH_ROUTE_PRODUCTS,
) -> torch.Tensor:
    """The bf16x3 flash route's arithmetic in plain PyTorch, float32 out.

    ``q [B, H, Sq, hd]``, ``k/v [B, KVH, Sk, hd]`` (grouped-query heads).
    q is scaled by ``1/sqrt(hd)`` in float32, then ``S = Q K^T`` is summed
    from the first ``products`` of FLASH_PRODUCTS of the bf16x3 splits of the
    scaled q and of k; an online softmax over FLASH_BLOCK_K-key tiles keeps
    float32 m, l and accumulator in log2 units (masked logits -1e30, l
    clamped at 1e-30), and each tile's ``P V`` is summed the same way from
    the splits of P and v (in one float32 product over the concatenated
    terms) and added to the rescaled accumulator. ``products`` is one count for both products or
    a pair (``S``, ``P V``); FLASH_ROUTE_PRODUCTS is the kernel's, fewer the
    controls.
    """
    return _flash_bf16x3_sets(q, k, v, causal, q_offset, [products])[0]


def _flash_bf16x3_sets(q, k, v, causal: bool, q_offset: int, sets: list) -> list:
    """:func:`flash_attention_bf16x3` for each product set of ``sets`` (counts or
    (S, P V) pairs), sharing each tile's S cross-products among them. A causal
    call runs its queries in chunks of 512, each over the key tiles it sees:
    a tile past every query of a chunk changes none of its rows (p = 0,
    corr = 1 once a row has seen key 0)."""
    sets = [(n, n) if isinstance(n, int) else n for n in sets]
    f32 = torch.float32
    h, sq, hd = q.shape[1], q.shape[2], q.shape[3]
    group = h // k.shape[1]
    sk = k.shape[2]
    qs = split_bf16x3(q.to(f32) * (1.0 / math.sqrt(hd)))
    ks = split_bf16x3(k.to(f32).repeat_interleave(group, dim=1).transpose(-1, -2))
    vs = split_bf16x3(v.to(f32).repeat_interleave(group, dim=1))
    log2e = 1.4426950408889634
    neg = -1e30
    n_s_max = max(n for n, _ in sets)

    def rows(lo: int, hi: int) -> list:
        qc = tuple(t[:, :, lo:hi] for t in qs)
        m = [torch.full((*q.shape[:2], hi - lo, 1), neg, dtype=f32, device=q.device)
             for _ in sets]
        l = [torch.zeros_like(t) for t in m]
        acc = [torch.zeros((*q.shape[:2], hi - lo, hd), dtype=f32, device=q.device)
               for _ in sets]
        qpos = q_offset + torch.arange(lo, hi, device=q.device)[:, None]
        last = min(sk, q_offset + hi) if causal else sk  # keys any of these rows sees
        for k0 in range(0, last, FLASH_BLOCK_K):
            kt = tuple(t[..., k0:k0 + FLASH_BLOCK_K] for t in ks)
            vt = tuple(t[:, :, k0:k0 + FLASH_BLOCK_K] for t in vs)
            terms = [qc[i] @ kt[j] for i, j in FLASH_PRODUCTS[:n_s_max]]
            mask = None
            if causal:
                mask = qpos < k0 + torch.arange(kt[0].shape[-1], device=q.device)[None, :]
            for c, (n_s, n_pv) in enumerate(sets):
                x = terms[n_s - 1]
                for t in reversed(terms[:n_s - 1]):  # smallest first, as the kernel
                    x = x + t
                x = x * log2e
                if mask is not None:
                    x = x.masked_fill(mask, neg)
                m_new = torch.maximum(m[c], x.amax(-1, keepdim=True))
                corr = torch.exp2(m[c] - m_new)
                p = torch.exp2(x - m_new)
                l[c] = l[c] * corr + p.sum(-1, keepdim=True)
                # the tile's P V from its n_pv cross-products, as one product over
                # the concatenated terms, added to the rescaled accumulator
                sp = split_bf16x3(p)
                pairs = FLASH_PRODUCTS[:n_pv]
                pc = torch.cat([sp[i] for i, _ in pairs], -1)
                vc = torch.cat([vt[j] for _, j in pairs], -2)
                a = acc[c] * corr
                acc[c] = torch.baddbmm(a.flatten(0, 1), pc.flatten(0, 1),
                                       vc.flatten(0, 1)).view_as(a)
                m[c] = m_new
        return [a / torch.clamp(b, min=1e-30) for a, b in zip(acc, l)]

    chunk = 512 if causal else sq
    parts = [rows(lo, min(lo + chunk, sq)) for lo in range(0, sq, chunk)]
    return [torch.cat([part[c] for part in parts], 2) for c in range(len(sets))]


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
