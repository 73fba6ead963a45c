"""Analytic energy model built from the paper's Table II (pure Python).

Network energy = MACs x PDP(format, activation bits) + a DRAM term per
weight byte streamed. PDP between the two published activation widths
(5 and 8 bits) is linearly interpolated. A copy of the JAX package's
``core/energy.py`` for the conversion report, Fig. 15(b) and the serve
engine's modeled energy per token (:func:`lm_token_energy`).
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

# DRAM and SRAM access energy (pJ/byte) charged per weight byte; PDP covers compute only.
DRAM_PJ_PER_BYTE = 20.0
SRAM_PJ_PER_BYTE = 1.0

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


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


def lm_weight_macs_per_token(cfg) -> int:
    """Weight-MACs per decoded token of a transformer LM.

    Attention projections (q/k/v/o), the FFN matmuls and the LM head,
    times layers: the MACs that stream weights, which the Table II
    weight-stationary model charges. Attention score MACs depend on the
    context and read no weights, so they are left out. MoE counts the
    ``topk`` active experts.
    """
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.head_dim or d // h
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ffn = (3 if cfg.mlp_kind == "swiglu" else 2) * d * cfg.d_ff
    if cfg.n_experts:
        ffn *= cfg.topk
    return cfg.n_layers * (attn + ffn) + d * cfg.vocab


def lm_cache_bytes_per_token(cfg, max_len: int, *, kv_bits: int = 0) -> int:
    """Modeled DRAM bytes of KV cache read per decoded token, per slot.

    A decode step streams the slot's whole K and V history at full context
    (``2 * L * max_len * KV * hd`` elements) at the cache's element width:
    the config dtype, or one byte for ``kv_bits=8`` static int8 codes plus
    the per-(layer, head) float32 scales.
    """
    n_layers = cfg.n_dec_layers or cfg.n_layers
    kv = cfg.n_kv_heads
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    elem = 1 if kv_bits else _DTYPE_BYTES[cfg.dtype_str]
    scale_bytes = 2 * n_layers * kv * 4 if kv_bits else 0
    return 2 * n_layers * int(max_len) * kv * hd * elem + scale_bytes


def lm_token_energy(cfg, params, act_bits: int | None = None) -> dict:
    """Table II modeled energy (nJ) per decoded token for an LM params tree.

    The MAC format is the packed leaves' most common ``fmt_name``
    (``conventional_fp`` for a float tree); the memory term charges the
    tree's storage bytes, one whole-tree weight stream per decode step.
    Returns the :func:`network_energy_nj` split plus the format and MAC
    count it used.
    """
    from collections import Counter

    from repro_torch.kernels.ops import PackedWeight, packed_tree_bytes, tree_leaves

    fmts = Counter(leaf.fmt_name for leaf in tree_leaves(params)
                   if isinstance(leaf, PackedWeight))
    fmt = fmts.most_common(1)[0][0] if fmts else "conventional_fp"
    macs = lm_weight_macs_per_token(cfg)
    e = network_energy_nj(macs, packed_tree_bytes(params), fmt, act_bits or 8)
    return {"fmt": fmt, "macs_per_token": macs, **e}
