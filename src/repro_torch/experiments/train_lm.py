"""Train a ~100M-parameter decoder LM for a few hundred steps on one card.

The JAX package's ``examples/train_lm.py`` on the port's training stack:
AdamW with float32 masters, remat, checkpoints with auto-resume, the
straggler monitor; the same config (16 layers, d 512, vocab 32000,
float32) and flags.

    python -m repro_torch.experiments.train_lm [--steps 300] [--batch 8] [--seq 256]
        [--ckpt-dir build/train_lm] [--compress {int8,elp4}] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs.base import ArchConfig
from repro_torch.experiments.common import RESULTS
from repro_torch.runtime.train_loop import TrainSetup, train

# about 100M parameters: 16 layers x d 512, vocab 32k
CFG = ArchConfig(
    name="lm-100m",
    family="dense",
    n_layers=16,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32000,
    head_dim=64,
    mlp_kind="swiglu",
    dtype_str="float32",
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(os.path.dirname(RESULTS), "train_lm"))
    ap.add_argument("--compress", default=None, choices=[None, "int8", "elp4"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    print(f"model: {CFG.name} ({CFG.param_count() / 1e6:.0f}M params)")
    setup = TrainSetup(cfg=CFG, mesh=None, lr_peak=6e-4, warmup=50, total_steps=args.steps,
                       remat=True, compress=args.compress)
    out = train(setup, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=10, device=args.device)
    losses = out["losses"]
    if len(losses) >= 10:
        print(f"loss: first10={sum(losses[:10]) / 10:.3f} last10={sum(losses[-10:]) / 10:.3f}")
    print("straggler report:", out["straggler_report"])
    return out


if __name__ == "__main__":
    main()
