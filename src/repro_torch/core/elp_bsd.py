"""Encoded Low-Precision Binary Signed Digit (ELP_BSD) formats (paper Sec. IV).

A weight is a sum of signed power-of-two digits; each digit draws its
shift count from a small per-digit set and is stored as
``[sign bit (if signed)] [ceil(log2(n_i)) index bits]``, LSB-first. A
code's value is ``sum_d sign_d * 2^{shift_d}``; the scaled weight is
``SF * value`` with ``SF = max|W| / 2^{max shift}``.

This is the port's own numpy copy of the format tables: the level
table, the per-digit field layout and the shift-add decomposition that
the CUDA kernels receive as a small struct. It must agree exactly with
the JAX package's ``core/elp_bsd.py`` (held by ``tests/test_torch_core.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "DigitSpec",
    "ElpBsdFormat",
    "FORMAT_A",
    "FORMAT_B",
    "FORMAT_C",
    "FORMAT_D",
    "TABLE2_FORMATS",
    "PRESET_FORMATS",
    "FORMAT_ALIASES",
    "decode_codes",
    "resolve_format",
    "storage_bytes",
]


@dataclasses.dataclass(frozen=True)
class DigitSpec:
    """One signed power-of-two digit: its allowed shift counts and sign bit."""

    shifts: tuple[int, ...]
    signed: bool = True

    def __post_init__(self) -> None:
        if len(self.shifts) == 0:
            raise ValueError("digit needs at least one shift count")
        if len(set(self.shifts)) != len(self.shifts):
            raise ValueError(f"duplicate shift counts: {self.shifts}")

    @property
    def index_bits(self) -> int:
        return max(1, math.ceil(math.log2(len(self.shifts)))) if len(self.shifts) > 1 else 0

    @property
    def bits(self) -> int:
        return self.index_bits + (1 if self.signed else 0)


@dataclasses.dataclass(frozen=True)
class ElpBsdFormat:
    """A complete ELP_BSD format: an ordered tuple of digits."""

    digits: tuple[DigitSpec, ...]
    name: str = "elp_bsd"

    def __post_init__(self) -> None:
        if len(self.digits) == 0:
            raise ValueError("format needs at least one digit")

    @property
    def bits_per_weight(self) -> int:
        return sum(d.bits for d in self.digits)

    @property
    def max_shift(self) -> int:
        return max(max(d.shifts) for d in self.digits)

    def code_values(self) -> np.ndarray:
        """Value of every raw code ``0 .. 2^bits_per_weight - 1`` (by the decoder)."""
        return decode_codes(np.arange(2**self.bits_per_weight, dtype=np.int64), self)

    def levels(self) -> np.ndarray:
        """Sorted unique quantization levels (unscaled TQL)."""
        return np.unique(self.code_values())

    def level_codes(self) -> np.ndarray:
        """For each entry of :meth:`levels`, the lowest raw code producing it."""
        cv = self.code_values()
        order = np.argsort(cv, kind="stable")
        first = np.searchsorted(cv[order], self.levels(), side="left")
        return order[first].astype(np.int32)

    def field_layout(self) -> list[tuple[int, int, int]]:
        """(offset, sign_bits, index_bits) per digit, LSB-first packing."""
        out = []
        off = 0
        for d in self.digits:
            out.append((off, 1 if d.signed else 0, d.index_bits))
            off += d.bits
        return out

    def shift_tables(self) -> list[np.ndarray]:
        """Per-digit shift LUTs padded to ``2**index_bits`` entries (last repeated)."""
        tabs = []
        for d in self.digits:
            n = 2**d.index_bits if d.index_bits else 1
            t = np.asarray(d.shifts + (d.shifts[-1],) * (n - len(d.shifts)), dtype=np.int32)[:n]
            tabs.append(t)
        return tabs

    def shift_add_decomposition(
        self,
    ) -> list[tuple[int, int, int, np.ndarray, tuple[int, int] | None]]:
        """Per digit: ``(offset, sign_bits, index_bits, shift_lut, affine)``.

        ``affine`` is ``(a, b)`` when the LUT is the progression
        ``shift = a + b * index``, else None. This is what the decoders
        and both CUDA kernels consume.
        """
        out = []
        for (off, sbits, ibits), tab in zip(self.field_layout(), self.shift_tables()):
            tabl = [int(t) for t in tab]
            if len(tabl) == 1:
                affine: tuple[int, int] | None = (tabl[0], 0)
            else:
                step = tabl[1] - tabl[0]
                ok = all(tabl[i] == tabl[0] + i * step for i in range(len(tabl)))
                affine = (tabl[0], step) if ok else None
            out.append((off, sbits, ibits, tab, affine))
        return out


# The four Table II formats: 4 / 7 / 6 / 6 bits per weight.
FORMAT_A = ElpBsdFormat(
    (DigitSpec(shifts=tuple(range(0, 8)), signed=True),),
    name="elp_bsd_a4",
)
FORMAT_B = ElpBsdFormat(
    (
        DigitSpec(shifts=tuple(range(0, 8)), signed=True),
        DigitSpec(shifts=(1, 2, 4, 5), signed=True),
    ),
    name="elp_bsd_b7",
)
FORMAT_C = ElpBsdFormat(
    (
        DigitSpec(shifts=tuple(range(0, 8)), signed=True),
        DigitSpec(shifts=(1, 5), signed=True),
    ),
    name="elp_bsd_c6",
)
FORMAT_D = ElpBsdFormat(
    (
        DigitSpec(shifts=(0, 2, 5, 7), signed=True),
        DigitSpec(shifts=(1, 2, 4, 5), signed=True),
    ),
    name="elp_bsd_d6",
)

TABLE2_FORMATS: tuple[ElpBsdFormat, ...] = (FORMAT_A, FORMAT_B, FORMAT_C, FORMAT_D)
PRESET_FORMATS: dict[str, ElpBsdFormat] = {f.name: f for f in TABLE2_FORMATS}

# Short tags accepted everywhere a format is named.
FORMAT_ALIASES: dict[str, str] = {"elp4": "elp_bsd_a4", "elp8": "elp_bsd_c6"}


def resolve_format(fmt: "ElpBsdFormat | str") -> ElpBsdFormat:
    """An :class:`ElpBsdFormat`, a preset name or an alias -> the format."""
    if isinstance(fmt, ElpBsdFormat):
        return fmt
    if isinstance(fmt, str):
        name = FORMAT_ALIASES.get(fmt, fmt)
        try:
            return PRESET_FORMATS[name]
        except KeyError:
            raise ValueError(
                f"unknown ELP_BSD format {fmt!r}; expected one of "
                f"{sorted(PRESET_FORMATS)} or an alias in {sorted(FORMAT_ALIASES)}"
            ) from None
    raise TypeError(
        f"format must be an ElpBsdFormat or a preset/alias name, got {type(fmt).__name__}"
    )


def decode_codes(codes: np.ndarray, fmt: ElpBsdFormat) -> np.ndarray:
    """Decode raw codes to unscaled float64 values (numpy bit-level oracle)."""
    codes = np.asarray(codes, dtype=np.int64)
    out = np.zeros(codes.shape, dtype=np.float64)
    for (off, sbits, ibits), tab in zip(fmt.field_layout(), fmt.shift_tables()):
        field = (codes >> off) & ((1 << (sbits + ibits)) - 1)
        idx = field & ((1 << ibits) - 1) if ibits else np.zeros_like(field)
        sign = np.where((field >> ibits) & 1, -1.0, 1.0) if sbits else 1.0
        out = out + sign * np.exp2(tab[idx].astype(np.float64))
    return out


def storage_bytes(n_weights: int, fmt: ElpBsdFormat) -> int:
    """Bytes for ``n_weights`` bit-packed at the format's width (Table II accounting)."""
    return (n_weights * fmt.bits_per_weight + 7) // 8
