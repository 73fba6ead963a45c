"""Multi-pod dry-run: every (arch x shape x mesh) cell counted on ``meta``, no allocation.

The JAX package's ``repro/launch/dryrun.py`` lowers and compiles each
cell's real jitted entry point from abstract inputs. The port's counterpart
of ``jax.jit(...).lower(abstract args)`` is to run the real step once on
``meta`` tensors at one rank's local shapes, under
:func:`repro_torch.launch.hlo_stats.count_cost`: the full train step (the
loss and its gradient with remat, ZeRO-1 AdamW, ``moe_impl="ep"``, optional
``seq_parallel``) or the serve prefill / decode step (``prefill_fn`` /
``decode_fn`` of :func:`repro_torch.serve.engine.build_serve_fns` on a
``ServeSetup``). A ``meta`` tensor is counted, never computed: the kernel
wrappers and the collectives return empty ``meta`` results and report their
cost. Each cell must succeed on

  * the single-pod 16 x 16 ``("data", "model")`` mesh (256 ranks), and
  * the 2 x 16 x 16 ``("pod", "data", "model")`` mesh (512 ranks),

built by :func:`repro_torch.launch.mesh.make_production_mesh` over a
one-process fake process group of that many ranks
(``torch.testing._internal.distributed.fake_pg``): the process is rank 0,
its mesh coordinate the origin, and the group is torn down after the cell.
The fake group becomes the default process group of the process that starts
it, so a caller with a group of its own runs cells in a subprocess (or
passes a mesh over its own group, as ``chip_smoke.py``'s (1, 1) cell does).

Each cell's JSON keeps the reference's keys where they mean the same thing:
``status``, ``memory`` (argument, output and temp bytes,
``total_per_device_gib``), ``cost``, ``collectives``, ``corrected``,
``roofline`` and ``useful_flop_ratio``. The argument bytes are the rank's
parameters, optimizer state, cache and inputs, exact from the ``meta``
tensors; temp bytes are the peak of live intermediate storage that the
counting dispatch mode follows, less the outputs. Left out, and why:

  * ``cpu_convert_artifact_bytes`` and ``temp_bytes_tpu_adjusted``: XLA's CPU
    backend hoists float32 copies out of a compiled loop; an eager step holds
    only what its ops allocate;
  * ``bodies`` and ``roofline_raw_uncorrected``: XLA counts a ``while`` body
    once, which the reference's ``body_probe`` corrects; the port's layer
    stacks are Python loops, so every layer is counted, and ``corrected`` is
    the count itself (``launch/body_probe.py`` has no counterpart);
  * ``quant_dequant_overhead_bytes`` and ``bytes_xla_unfused``: the reference
    subtracts the dequantized copy that its XLA fallback materializes; the
    port's packed wrappers count code bytes, and where the port does decode a
    whole stack (``moe_dense``, ``models/moe.py``) the count shows it;
  * ``code_bytes``: no executable is generated.

Host syncs break ``meta`` evaluation. The decode step's position is passed as
a Python int (``shape.seq_len - 1``: attention reads the whole cache).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes]
  python -m repro_torch.launch.dryrun --arch kimi_k2_1t_a32b --shape decode_32k --quant elp4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config, input_specs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import hlo_stats
from repro_torch.models import get_model

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT_DIR = os.path.join(ROOT, "build", "dryrun")


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def mesh_name(shape: tuple[int, ...]) -> str:
    return "x".join(map(str, shape))


@contextlib.contextmanager
def fake_group(world: int):
    """A one-process fake process group of ``world`` ranks as the default group (this
    process is rank 0), destroyed after the block. Raises if a group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists: run the dry-run's production cells in "
                           "a process of their own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def grid_mesh(shape: tuple[int, ...], device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the default group: axes
    ``("data", "model")``, or ``("pod", "data", "model")`` for three dims. The
    production shapes go through :func:`repro_torch.launch.mesh.make_production_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_production_mesh

    if shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3, device=device_type)
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def _local_inputs(specs: dict, mesh) -> dict:
    from repro_torch.runtime.elastic import local_block
    from repro_torch.runtime.sharding import input_spec

    return {k: local_block(v, mesh, input_spec(tuple(v.shape), mesh)) if v.ndim else v
            for k, v in specs.items()}


def cell_step(cfg: ArchConfig, shape: ShapeConfig, mesh, quant: str | None = None, *,
              flash: bool = False, seqp: bool = False, kvq: bool = False, device="meta",
              materialize=None):
    """``(fn, args)``: the cell's real step and its arguments at this rank's local
    shapes (parameters, optimizer state or cache, inputs); ``fn(*args)`` runs the step
    once. On ``meta`` (the default) every argument is shape-only. For a serve cell,
    ``materialize`` maps the whole ``meta`` parameter tree (packed with ``quant``) to
    real tensors, and the cache and inputs are made on ``device``: the same step, run
    for real."""
    from repro_torch.runtime.train_loop import (
        TrainSetup,
        init_opt_state,
        local_params,
        make_train_step,
        whole_shapes,
    )
    from repro_torch.serve.engine import ServeSetup, build_serve_fns

    api = get_model(cfg)
    specs = input_specs(cfg, shape)
    whole = whole_shapes(cfg)
    if shape.kind == "train":
        setup = TrainSetup(cfg=cfg, mesh=mesh, remat=True, moe_impl="ep", seq_parallel=seqp)
        params = local_params(setup, whole)
        opt_state = init_opt_state(setup, whole)
        step = make_train_step(setup, api)
        return step, (params, opt_state, None, _local_inputs(specs, mesh))

    setup = ServeSetup(cfg=cfg, mesh=mesh, max_len=shape.seq_len, batch=shape.global_batch,
                       moe_impl="ep", flash_decode=flash)
    if quant:
        from repro_torch.runtime.quantized_params import abstract_quantize_tree

        whole = abstract_quantize_tree(whole, cfg, quant)
    if materialize is not None:
        whole = materialize(whole)
    lo, hi = setup.rows()
    kw = {"quant": True} if kvq and cfg.family in ("dense", "moe", "vlm") else {}
    cache = api.init_cache(cfg, hi - lo, shape.seq_len, device=device, **kw)
    params, cache = setup.layout(whole, cache)
    prefill_fn, decode_fn = build_serve_fns(setup, api)
    if shape.kind == "prefill":
        def prefill(params, batch, cache):
            with torch.no_grad():
                return prefill_fn(params, batch, cache)

        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in _local_inputs(specs, mesh).items()}
        return prefill, (params, batch, cache)
    if cfg.family in ("encdec", "audio"):
        # serve state = (decoder KV cache, encoder output: this rank's rows)
        enc_out = torch.zeros((hi - lo, shape.seq_len, cfg.d_model), dtype=cfg.dtype,
                              device=device)
        cache = (cache, enc_out)
    token = torch.zeros((hi - lo, 1), dtype=torch.int32, device=device)
    pos = shape.seq_len - 1

    def decode(params, token, cache):
        with torch.no_grad():
            return decode_fn(params, token, cache, pos)

    return decode, (params, token, cache)


def materialize(tree, device, seed: int = 0):
    """Real tensors on ``device`` for the ``meta`` tree ``tree`` (a whole parameter
    tree, packed or not), seeded: float leaves N(0, 1) over the square root of their
    fan-in (1 for a vector), packed codes uniform bytes with the scale factor that
    gives the decoded weights about that spread. The values only have to be finite
    through a step: they let the same step that the dry-run counts run for real."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels.ops import PackedWeight

    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(x):
        if isinstance(x, PackedWeight):
            codes = torch.randint(0, 256, tuple(x.codes.shape), generator=gen, device=device,
                                  dtype=torch.uint8)
            top = float(np.abs(x.fmt.levels()).max())
            sf = torch.full(tuple(x.sf.shape), 1.0 / (top * math.sqrt(x.shape[0])),
                            dtype=x.sf.dtype, device=device)
            return dataclasses.replace(x, codes=codes, sf=sf)
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        fan_in = x.shape[-2] if x.ndim >= 2 else 1
        w = torch.randn(tuple(x.shape), generator=gen, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(x.dtype)

    return leaf(tree)


def count_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, quant: str | None = None, *,
               flash: bool = False, seqp: bool = False, kvq: bool = False) -> dict:
    """The counted record of one cell on ``mesh`` (a ``DeviceMesh`` over the default
    group): ``memory``, ``cost``, ``collectives``, ``kernels``, ``corrected``,
    ``roofline`` and ``useful_flop_ratio``, plus ``count_s``."""
    t0 = time.time()
    fn, args = cell_step(cfg, shape, mesh, quant, flash=flash, seqp=seqp, kvq=kvq)
    c = hlo_stats.step_cost(fn, *args)
    rec: dict = {"count_s": time.time() - t0, "memory": c["memory"]}
    rec["cost"] = {"flops_per_device": c["flops"], "bytes_per_device": c["bytes_accessed"],
                   "min_bytes_per_device": c["min_bytes"]}
    rec["collectives"] = {"per_device_bytes": c["collective_bytes"],
                          "count": sum(c["collective_calls"].values()), "by_op": c["by_op"],
                          "calls": c["collective_calls"]}
    rec["kernels"] = c["kernels"]
    # no scanned bodies to correct: every layer is counted (module docstring)
    rec["corrected"] = {"flops": c["flops"], "bytes": c["bytes_accessed"],
                        "coll_bytes": c["collective_bytes"]}
    terms = hlo_stats.roofline_terms(c["flops"], c["bytes_accessed"], c["collective_bytes"],
                                     hlo_stats.link_bandwidth(mesh),
                                     c["min_bytes"])
    mf = model_flops(cfg, shape)
    terms["model_flops"] = mf
    terms["counted_flops_global"] = c["flops"] * mesh.mesh.numel()
    terms["useful_flop_ratio"] = mf / max(terms["counted_flops_global"], 1.0)
    rec["roofline"] = terms
    rec["useful_flop_ratio"] = terms["useful_flop_ratio"]
    return rec


def run_cell(
    arch_id: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: str | None,
    quant: str | None = None,
    verbose: bool = True,
    tag: str = "",
    flash: bool = False,
    seqp: bool = False,
    kvq: bool = False,
) -> dict:
    """One cell's record on the production mesh (``multi_pod``: 2 x 16 x 16, else
    16 x 16) over a fake group made for it, also written to ``out_dir`` as JSON. A
    failed cell is recorded with its traceback, ``status`` ``"fail"``."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    grid = (2, 16, 16) if multi_pod else (16, 16)
    rec: dict = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name(grid),
        "devices": math.prod(grid),
        "quant": quant or "none",
        "flash": flash,
        "seqp": seqp,
        "kvq": kvq,
        "status": "ok",
    }
    try:
        with fake_group(math.prod(grid)):
            rec.update(count_cell(cfg, shape, grid_mesh(grid), quant, flash=flash, seqp=seqp,
                                  kvq=kvq))
        if verbose:
            _print_cell(rec)
    except Exception as e:  # noqa: BLE001 — a failed cell is a reported bug
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"--- {arch_id} x {shape_name} x {rec['mesh']} FAILED: {rec['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{quant}" if quant else ""
        suffix += f"__{tag}" if tag else ""
        path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{rec['mesh']}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _print_cell(rec: dict) -> None:
    m, c, co, t = rec["memory"], rec["cost"], rec["collectives"], rec["roofline"]
    print(f"--- {rec['arch']} x {rec['shape']} x {rec['mesh']} quant={rec['quant']} ---")
    print(f"memory: arguments {m['argument_bytes']} B, outputs {m['output_bytes']} B, temp "
          f"{m['temp_bytes']} B: {m['total_per_device_gib']:.3f} GiB a device")
    print(f"cost: flops/dev={c['flops_per_device']:.3e} eager bytes/dev="
          f"{c['bytes_per_device']:.3e} least bytes/dev={c['min_bytes_per_device']:.3e}")
    print(f"collectives: {co['per_device_bytes']:.3e} B/dev over {co['count']} calls "
          f"{co['by_op']}")
    print(f"kernels: {rec['kernels']}")
    print(f"roofline: compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s (eager "
          f"traffic; least {t['min_memory_s']:.4f}s) collective={t['collective_s']:.4f}s -> "
          f"{t['bottleneck']}")
    print(f"useful-FLOP ratio (6ND/counted): {t['useful_flop_ratio']:.3f} | counted in "
          f"{rec['count_s']:.1f}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true", help="every arch x shape, both meshes")
    ap.add_argument("--multipod", action="store_true", help="use the 2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", default=None, choices=[None, "elp4", "elp8"])
    ap.add_argument("--flash", action="store_true", help="flash-decoding KV layout")
    ap.add_argument("--seqp", action="store_true", help="sequence-parallel residuals")
    ap.add_argument("--kvq", action="store_true", help="int8 KV cache")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for aid in ARCH_IDS:
            for sh in applicable_shapes(get_config(aid)):
                cells.append((aid, sh, False))
                cells.append((aid, sh, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        meshes = [False, True] if args.both_meshes else [args.multipod]
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    failures = 0
    t0 = time.time()
    for aid, sh, mp in cells:
        rec = run_cell(aid, sh, mp, args.out, quant=args.quant, tag=args.tag,
                       flash=args.flash, seqp=args.seqp, kvq=args.kvq)
        failures += rec["status"] != "ok"
    print(f"\n{len(cells) - failures}/{len(cells)} cells OK in {time.time() - t0:.1f} s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
