"""Table II: MAC/PE characteristics and the network-level energy model.

Reprints the synthesized MAC numbers, derives the paper's Sec. VI-C
ratios, and extends them to network energy (compute plus DRAM weight
traffic) of full-size AlexNet and VGG-16 in a4, c6 and the conventional
8-bit baseline, where the packed ELP_BSD widths also shrink the memory
term. Pure arithmetic on the Table II model; the rows are the JAX
package's ``benchmarks/table2_energy.py`` rows, character for character.

    python -m repro_torch.experiments.table2_energy
"""
from __future__ import annotations

from repro_torch.core import PRESET_FORMATS, network_energy_nj, pdp_fj, pdp_reduction, storage_bytes
from repro_torch.core.energy import TABLE2
from repro_torch.experiments import common
from repro_torch.models.cnn import ALEXNET, VGG16, Conv, Fc, Pool


def _param_count(spec) -> int:
    """Conv and fc weights of ``spec`` (no biases), with the energy model's
    spatial bookkeeping (``hw //= stride``)."""
    ch, hw, total = spec.input_ch, spec.input_hw, 0
    for l in spec.layers:
        if isinstance(l, Conv):
            total += l.k * l.k * ch * l.ch
            ch = l.ch
            hw //= l.stride
        elif isinstance(l, Pool):
            hw //= l.stride
        elif isinstance(l, Fc):
            total += (hw * hw * ch if hw else ch) * l.out
            hw = 0
            ch = l.out
    return total


def main() -> None:
    for (name, ab), pt in TABLE2.items():
        common.emit(
            f"table2_{name}_a{ab}",
            0.0,
            f"area={pt.area_cells};power_uW={pt.power_uw};delay_ns={pt.delay_ns};pdp_fJ={pt.pdp_fj}",
        )
    # the Sec. VI-C headline ratios
    common.emit(
        "table2_claim_most_power_hungry_vs_booth",
        0.0,
        f"b7@8_vs_booth={1 - pdp_fj('elp_bsd_b7', 8) / pdp_fj('booth_mac', 8):.3f}",
    )
    common.emit(
        "table2_claim_76pct_vs_conventional",
        0.0,
        f"c6@5_vs_conv={pdp_reduction('elp_bsd_c6', 5):.3f}",
    )
    # network energy of the full-size nets, weight-stationary dataflow
    for spec in (ALEXNET, VGG16):
        macs = spec.macs()
        n_params = _param_count(spec)
        for fmt_name in ("elp_bsd_a4", "elp_bsd_c6", "conventional_fp"):
            fmt = PRESET_FORMATS.get(fmt_name)
            wb = storage_bytes(n_params, fmt) if fmt else n_params  # 8-bit baseline
            e = network_energy_nj(macs, wb, fmt_name, 8)
            common.emit(
                f"table2_net_{spec.name}_{fmt_name}",
                0.0,
                f"macs={macs};weight_MB={wb / 1e6:.1f};compute_uJ={e['compute_nj'] / 1e3:.1f};"
                f"mem_uJ={e['memory_nj'] / 1e3:.1f};total_uJ={e['total_nj'] / 1e3:.1f}",
            )


if __name__ == "__main__":
    main()
