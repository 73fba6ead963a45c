"""The JAX package's dry-run of ``tests/test_torch_dryrun.py``'s cells, in a subprocess
with 4 fake CPU devices: ``_lower_cell`` and ``body_probe.corrected_totals`` of a
reduced config of each family on a ``(2, 2)`` mesh of ``Auto`` axes, at the
small shapes of :data:`SHAPES`. Writes one ``.npz`` of per-device FLOPs, bytes,
wire bytes and argument bytes.

    python tests/torch_dryrun_ref.py OUT.npz [ARCH ...]
"""
from __future__ import annotations

import os
import sys

ARCHS = ("qwen3_8b", "olmoe_1b_7b", "mamba2_780m", "recurrentgemma_2b",
         "seamless_m4t_large_v2", "internvl2_26b")  # dense, moe, ssm, hybrid, audio, vlm
# (kind, seq_len, global batch): the reference's ShapeConfig fields at a CPU size
SHAPES = (("train", 64, 8), ("prefill", 128, 4), ("decode", 128, 4))
MESH = (2, 2)


def main(out_path: str, archs=ARCHS) -> None:
    import jax

    # the device count is fixed at jax's first use: touch it before the dry-run module
    # (whose first lines ask for 512 devices) is imported
    assert len(jax.devices()) == 4, jax.devices()
    import numpy as np

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import body_probe
    from repro.launch import dryrun as D
    from repro.launch.hlo_stats import collective_stats

    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    res = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        for kind, seq, batch in SHAPES:
            shape = ShapeConfig(kind, seq, batch, kind)
            lowered, extras = D._lower_cell(cfg, shape, mesh, None)
            compiled = lowered.compile()
            cost = compiled.cost_analysis()
            cost = cost[0] if isinstance(cost, (list, tuple)) else cost
            coll = collective_stats(compiled.as_text())
            bodies = body_probe.probe(cfg, shape, mesh, extras["pctx"], extras["aparams"],
                                      extras["acache"])
            tot = body_probe.corrected_totals(float(cost["flops"]), float(cost["bytes accessed"]),
                                              coll.per_device_bytes, bodies)
            key = f"{arch}/{kind}"
            res[f"{key}/flops"] = tot["flops"]
            res[f"{key}/bytes"] = tot["bytes"]
            res[f"{key}/coll_bytes"] = tot["coll_bytes"]
            res[f"{key}/argument_bytes"] = compiled.memory_analysis().argument_size_in_bytes
    np.savez(out_path, **{k: np.float64(v) for k, v in res.items()})


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1], tuple(sys.argv[2:]) or ARCHS)
