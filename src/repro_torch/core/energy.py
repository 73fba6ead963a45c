"""Analytic energy model built from the paper's Table II (pure Python).

Network energy = MACs x PDP(format, activation bits) + a DRAM term per
weight byte streamed. PDP between the two published activation widths
(5 and 8 bits) is linearly interpolated. A copy of the JAX package's
``core/energy.py`` for the conversion report and Fig. 15(b).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MacPoint:
    area_cells: float
    power_uw: float
    delay_ns: float
    pdp_fj: float


# (format name, activation bits) -> synthesized MAC characteristics.
TABLE2: dict[tuple[str, int], MacPoint] = {
    ("elp_bsd_a4", 8): MacPoint(556, 28.55, 2.30, 65.68),
    ("elp_bsd_a4", 5): MacPoint(450, 23.06, 1.99, 45.79),
    ("elp_bsd_b7", 8): MacPoint(838, 59.60, 1.85, 109.96),
    ("elp_bsd_b7", 5): MacPoint(694, 46.53, 1.71, 79.71),
    ("elp_bsd_c6", 8): MacPoint(814, 51.65, 1.85, 95.29),
    ("elp_bsd_c6", 5): MacPoint(676, 41.22, 1.71, 70.65),
    ("elp_bsd_d6", 8): MacPoint(835, 56.57, 1.81, 102.61),
    ("elp_bsd_d6", 5): MacPoint(680, 43.07, 1.62, 69.86),
    ("booth_mac", 8): MacPoint(1195, 86.73, 2.49, 216.12),
    ("conventional_fp", 8): MacPoint(1179, 83.56, 3.56, 297.47),
}

# DRAM access energy (pJ/byte) charged per weight byte; PDP covers compute only.
DRAM_PJ_PER_BYTE = 20.0


def pdp_fj(fmt_name: str, act_bits: int) -> float:
    """PDP per MAC in fJ, linearly interpolated in activation bit-width."""
    hi = TABLE2.get((fmt_name, 8))
    lo = TABLE2.get((fmt_name, 5))
    if hi is None:
        raise KeyError(f"unknown MAC format {fmt_name!r}")
    if lo is None:  # baselines: published at 8-bit only, scale linearly in bits
        return hi.pdp_fj * act_bits / 8.0
    if act_bits >= 8:
        return hi.pdp_fj * act_bits / 8.0
    t = (act_bits - 5) / 3.0
    return lo.pdp_fj + t * (hi.pdp_fj - lo.pdp_fj)


def network_energy_nj(
    macs: int,
    weight_bytes: int,
    fmt_name: str,
    act_bits: int,
    *,
    weight_reuse: float = 1.0,
) -> dict[str, float]:
    """Network-level inference energy estimate (nJ): compute, memory and total."""
    compute_nj = macs * pdp_fj(fmt_name, act_bits) * 1e-6
    memory_nj = weight_bytes * weight_reuse * DRAM_PJ_PER_BYTE * 1e-3
    return {
        "compute_nj": compute_nj,
        "memory_nj": memory_nj,
        "total_nj": compute_nj + memory_nj,
    }


def pdp_reduction(fmt_name: str, act_bits: int, baseline: str = "conventional_fp") -> float:
    """Fractional PDP reduction against a Table II baseline (the paper's headline)."""
    return 1.0 - pdp_fj(fmt_name, act_bits) / pdp_fj(baseline, 8)
