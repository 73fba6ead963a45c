"""Quickstart: CoNLoCNN conversion through the one front door, ``repro_torch.api``.

The JAX package's ``examples/quickstart.py`` on the port. It trains the mini
AlexNet on the synthetic task, then runs the whole paper pipeline with one
call: ``api.quantize`` drives the critical activation bit-width search
(Sec. V steps 1 and 5), per-layer SF, TQL, nearest-level quantization,
Algorithm 1 error compensation and ELP_BSD packing, and returns a
``QuantizedModel`` that serves on 4-bit codes (on the card, through the
packed kernels) and saves and loads as one artifact. A reloaded artifact
whose forward is not bit-identical exits nonzero.

    python -m repro_torch.experiments.quickstart [--steps 1200] [--device cpu]

``QUICKSTART_STEPS`` sets the training steps too (a smaller budget for a
smoke run); the trained weights are cached under ``build/experiments/``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.experiments import common
from repro_torch.models import cnn

SPEC = cnn.ALEXNET_MINI
SCHEME = api.QuantScheme(fmt="elp_bsd_a4", act="dynamic", ac=0.01, bw_max=8, bw_min=4)


def convert(params: dict, device=None, spec: cnn.CnnSpec = SPEC) -> api.QuantizedModel:
    """The Sec. V search and packing of the trained ``params`` on ``device``."""
    eval_fn = common.make_eval_fn(spec, device=device)
    return api.quantize(spec, params, SCHEME, eval_fn=eval_fn, device=device)


def eval_batch(n: int = 8, spec: cnn.CnnSpec = SPEC, index: int = 0, device=None):
    """Batch ``index`` of ``n`` synthetic images on ``device``."""
    x, _ = common.CnnDataset(spec.input_hw, spec.input_ch, common.N_CLASSES, n).np_batch(index)
    return torch.from_numpy(x).to(resolve_device(device))


def round_trip(qm: api.QuantizedModel, x: torch.Tensor, path: str, device=None) -> tuple:
    """``qm`` saved to ``path`` and loaded back on ``device``: ``(forward of qm,
    forward of the reloaded artifact, whether they are bit-identical)``."""
    first = qm.forward(x)
    qm.save(path)
    again = api.load(path, device=device).forward(x)
    return first, again, bool(torch.equal(first, again))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=int(os.environ.get("QUICKSTART_STEPS", "1200")))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"training {SPEC.name} on the synthetic task ({args.steps} steps) on {device} ...")
    params = common.train_mini_cnn(SPEC, steps=args.steps, device=device)

    print("converting with ELP_BSD{SF, s[0..7]} (4 bits/weight) + Algorithm 1 ...")
    qm = convert(params, device)
    r = qm.report
    print(f"  baseline accuracy : {r.baseline_accuracy:.4f}")
    print(f"  quantized accuracy: {r.accuracy:.4f} (loss {r.accuracy_loss:+.4f})")
    print(f"  activation bits   : {r.act_bits}")
    print(f"  weight compression: {r.compression:.1f}x ({r.raw_bytes} -> {r.packed_bytes} "
          f"bytes; bit-packed {r.encoded_bytes} bytes)")
    print(f"  est. inference energy: {r.energy_nj / 1e3:.1f} uJ")

    print("serving the packed path (every conv+fc weight stored as 4-bit codes) ...")
    packed_acc = common.make_eval_fn(SPEC, device=device)(qm.params, r.act_bits)
    x = eval_batch(device=device)
    with torch.no_grad():
        float_logits = cnn.forward(params, SPEC, x)
    print(f"  packed accuracy   : {packed_acc:.4f} (act bits {r.act_bits})")

    print("saving + reloading the artifact (checksummed manifest) ...")
    with tempfile.TemporaryDirectory() as tmp:
        packed_logits, _, same = round_trip(qm, x, os.path.join(tmp, f"{SPEC.name}_elp4"),
                                            device)
    drift = float((packed_logits - float_logits).abs().max())
    print(f"  quantized-vs-float max logit error: {drift:.2e}")
    print(f"  reload forward bit-identical: {same}")
    if not same:
        raise SystemExit("save/load round-trip drifted — artifact path broken")
    return {"report": r, "packed_accuracy": packed_acc, "drift": drift}


if __name__ == "__main__":
    main()
