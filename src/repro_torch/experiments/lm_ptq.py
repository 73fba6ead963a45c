"""ELP_BSD post-training quantization of a small decoder LM.

The JAX package's ``benchmarks/lm_ptq.py``: train ``lm-ptq`` (4 layers, d
128, float32) on the synthetic token stream, then quantize every matmul
weight with ELP_BSD a4 and c6 (Sec. V per tensor) and report the eval-loss
change without Algorithm 1, with it over the contracting rows
(``comp_row``, the activation-correlation analogue of the paper's conv
channels) and over the output columns (``comp_col``) -- the LM analogue
of Fig. 15(a).

    python -m repro_torch.experiments.lm_ptq [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import FORMAT_A, FORMAT_C
from repro_torch.core.methodology import quantize_model
from repro_torch.data.pipeline import LmDataset, shard_batch
from repro_torch.device import resolve_device
from repro_torch.experiments import common
from repro_torch.models import transformer as T
from repro_torch.runtime.train_loop import TrainSetup, train

CFG = ArchConfig(
    name="lm-ptq", family="dense", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=256, head_dim=32, dtype_str="float32",
)
STEPS = 200


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def run(*, params: dict | None = None, device=None) -> tuple[float, dict]:
    """``(float eval loss, {format: {"plain", "comp_row", "comp_col"}})``: ``params``
    (default: :func:`train`ed ``STEPS`` steps, batch 16 x 64, lr 3e-3 after 20 warmup
    steps, no remat), evaluated on 4 held-out batches (seed 123, steps 50000 on)."""
    device = resolve_device(device)
    if params is None:
        res = train(TrainSetup(cfg=CFG, mesh=None, lr_peak=3e-3, warmup=20, total_steps=200,
                               remat=False),
                    steps=STEPS, batch_size=16, seq_len=64, log_every=1000,
                    log_fn=lambda s: None, device=device)
        params = res["params"]
    ds = LmDataset(CFG, seq_len=64, batch=16, seed=123)
    batches = [shard_batch(ds.np_batch(50_000 + i), device=device) for i in range(4)]

    def eval_loss(p) -> float:
        with torch.no_grad():
            tot = sum(T.loss_fn(p, CFG, b["tokens"], b["labels"], remat=False) for b in batches)
        return float(tot / len(batches))

    base = eval_loss(params)
    flat = _flat(params)
    # group-axis ablation: compensate over the contracting rows (the
    # activation-correlation analogue) against the output columns
    ga_row = {k: (w.ndim - 2,) for k, w in flat.items() if w.ndim >= 2}
    ga_col = {k: (w.ndim - 1,) for k, w in flat.items() if w.ndim >= 2}
    out = {}
    for fmt in (FORMAT_A, FORMAT_C):
        qp, _ = quantize_model(flat, ga_row, fmt, compensate=False)
        qr, _ = quantize_model(flat, ga_row, fmt, compensate=True)
        qc, _ = quantize_model(flat, ga_col, fmt, compensate=True)
        out[fmt.name] = {
            "plain": eval_loss(_unflat(qp)),
            "comp_row": eval_loss(_unflat(qr)),
            "comp_col": eval_loss(_unflat(qc)),
        }
    return base, out


def report(base: float, out: dict) -> None:
    """Print the JAX package's ``lm_ptq_<format>`` rows."""
    for fmt, r in out.items():
        common.emit(
            f"lm_ptq_{fmt}",
            0.0,
            f"fp_loss={base:.4f};plain={r['plain']:.4f};comp_row={r['comp_row']:.4f};"
            f"comp_col={r['comp_col']:.4f};row_gain={r['plain'] - r['comp_row']:+.4f}",
        )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    report(*run(device=ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
