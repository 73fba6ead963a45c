"""Fig. 15(b): accuracy against PDP for the four Table II ELP_BSD formats.

For each format and activation bit-width (8..4) the trained mini CNN is
converted with the Sec. V pipeline (SF -> TQL -> nearest level ->
Algorithm 1) into packed ELP_BSD codes and evaluated on the packed path
(every conv and fc weight a PackedWeight; on the card the decode runs
inside the matmul kernels), not a float stand-in. PE energy is PDP per MAC
times the network's MACs, from the Table II model. Paper claims: even the
most power-hungry CoNLoCNN PE gives about 50 % PDP reduction against the
conventional one; about 76 % if a 1.44 % accuracy drop is acceptable.

    python -m repro_torch.experiments.fig15b_accuracy_pdp [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.core.elp_bsd import TABLE2_FORMATS
from repro_torch.core.energy import pdp_fj
from repro_torch.experiments import common
from repro_torch.models import cnn


def run(spec=cnn.ALEXNET_MINI, act_bits_range=(8, 7, 6, 5, 4), *, params=None,
        device=None) -> list[dict]:
    """One row per (format, activation bits), then the two Table II baselines.
    ``params`` default to :func:`common.train_mini_cnn`'s."""
    if params is None:
        params = common.train_mini_cnn(spec, device=device)
    eval_fn = common.make_eval_fn(spec, device=device)
    base = eval_fn(params, None)
    macs = spec.macs()
    rows = []
    for fmt in TABLE2_FORMATS:
        qm = api.quantize(spec, params, api.QuantScheme(fmt=fmt, compensate=True), device=device)
        qw, code_bytes = qm.params, qm.report.packed_weight_bytes
        for ab in act_bits_range:
            acc = eval_fn(qw, ab)
            pdp = pdp_fj(fmt.name, ab)
            rows.append({"format": fmt.name, "act_bits": ab, "accuracy": acc,
                         "acc_drop": base - acc, "pdp_fj": pdp,
                         "energy_uj": macs * pdp * 1e-9, "weight_bytes": code_bytes})
    raw_bytes = sum(w.numel() * w.element_size() for n, w in params.items() if n.endswith("_w"))
    for name in ("booth_mac", "conventional_fp"):
        rows.append({"format": name, "act_bits": 8, "accuracy": base, "acc_drop": 0.0,
                     "pdp_fj": pdp_fj(name, 8), "energy_uj": macs * pdp_fj(name, 8) * 1e-9,
                     "weight_bytes": raw_bytes})
    return rows


def report(rows: list[dict]) -> None:
    """Print the JAX package's ``name,us,derived`` rows and the two claim lines."""
    conv = next(r for r in rows if r["format"] == "conventional_fp")
    for r in rows:
        red = 1.0 - r["pdp_fj"] / conv["pdp_fj"]
        common.emit(
            f"fig15b_{r['format']}_a{r['act_bits']}", 0.0,
            f"acc={r['accuracy']:.4f};drop={r['acc_drop']:+.4f};pdp_fj={r['pdp_fj']:.1f};"
            f"pdp_red={red:.3f}",
        )
    worst = max((r for r in rows if r["format"].startswith("elp")), key=lambda r: r["pdp_fj"])
    common.emit(
        "fig15b_claim_50pct", 0.0,
        f"most_power_hungry={worst['format']}@{worst['act_bits']}b;"
        f"pdp_red_vs_conv={1 - worst['pdp_fj'] / conv['pdp_fj']:.3f}",
    )
    ok = [r for r in rows if r["format"].startswith("elp") and r["acc_drop"] <= 0.0144 + 1e-9]
    if ok:
        best = min(ok, key=lambda r: r["pdp_fj"])
        common.emit(
            "fig15b_claim_76pct", 0.0,
            f"best_within_1.44pct={best['format']}@{best['act_bits']}b;"
            f"pdp_red={1 - best['pdp_fj'] / conv['pdp_fj']:.3f}",
        )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    report(run(device=ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
