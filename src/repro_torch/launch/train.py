"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The JAX package's ``repro/launch/train.py``: the mesh for whatever ranks
exist (``torchrun --nproc-per-node N -m repro_torch.launch.train ...``
gives an elastic mesh over the N ranks and the data-parallel ZeRO-1 step;
one process trains without a mesh), and the host loop with checkpoints,
auto-resume, the straggler monitor and optional gradient compression.
``--model-parallel`` (default 16, the reference's) is the model axis'
target, halved until it divides the rank count
(:func:`~repro_torch.runtime.elastic.choose_mesh_shape`); the products
split over it, and ``--seq-parallel`` splits the residual along the
sequence there (in the transformer stacks). ``--smoke`` runs the reduced config of the
same family; ``--device cpu`` runs on the host (default: the card). Two
ranks may share one card over a ``gloo`` group (start it before calling
:func:`main`): NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.mesh import world_mesh
from repro_torch.runtime.sharding import mesh_shape
from repro_torch.runtime.train_loop import TrainSetup, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", default=None, choices=[None, "int8", "elp4"])
    ap.add_argument("--seq-parallel", action="store_true",
                    help="split the residual along the sequence over the model axis")
    ap.add_argument("--model-parallel", type=int, default=16,
                    help="the model axis' target, halved until it divides the rank count")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh, device = world_mesh(args.model_parallel, args.device)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"mesh={mesh_shape(mesh) if mesh is not None else None} device={device}")
    setup = TrainSetup(
        cfg=cfg,
        mesh=mesh,
        lr_peak=args.lr,
        warmup=max(args.steps // 10, 5),
        total_steps=args.steps,
        remat=True,
        compress=args.compress,
        seq_parallel=args.seq_parallel,
    )
    out = train(setup, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
                ckpt_dir=args.ckpt_dir, device=device)
    print(f"final loss {out['losses'][-1]:.4f}; straggler {out['straggler_report']}")
    out["mesh"] = mesh_shape(mesh) if mesh is not None else None
    return out


if __name__ == "__main__":
    main()
