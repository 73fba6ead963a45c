"""Rank bodies and the JAX reference of ``tests/test_torch_distributed.py``.

The same numpy inputs (:func:`make_inputs`) go to two runs:

* :func:`jax_reference`, run as ``python tests/torch_mesh_ranks.py jax IN OUT``
  in a subprocess that sees 4 fake CPU devices, computes the JAX package's
  ``moe_ep`` and ``flash_decode_attention`` under ``shard_map`` on meshes of
  those devices, ``compressed_mean`` over a 4-device axis, the dense oracle,
  and 2 single-device train steps on the whole batch (a dense and an MoE LM);
* :func:`rank_main`, the body of each of 4 ``gloo`` ranks started by
  ``torch.multiprocessing.spawn``, runs the port on the same inputs over
  ``DeviceMesh`` es of those ranks (each rank on its local block) and writes
  what it computed.

The test compares the two. Every key of the result files is a flat string.
"""
import math
import os
import sys

import numpy as np

WORLD = 4
MOE_KW = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
              vocab=64, head_dim=8, n_experts=8, topk=2, dtype_str="float32")
MOE_T = 256
MOE_CF = {"ample": 8.0, "tight": 0.5}  # capacity factors: no drops / many drops
MOE_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
LM_KW = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab=64, head_dim=8, dtype_str="float32")
# the dense LM, and an MoE LM whose experts take the expert exchange under a mesh
# (capacity factor 8: no drops, so the reference's meshless dense form is the same function)
TRAIN_MODELS = {"dense": LM_KW,
                "moe": dict(LM_KW, name="tm", family="moe", d_ff=32, n_experts=4, topk=2,
                            moe_capacity_factor=8.0)}
TRAIN_CASES = (("dense", "4x1"), ("dense", "2x1"), ("moe", "2x1"))
TRAIN = dict(lr_peak=1e-2, warmup=0, total_steps=10, remat=True)
TRAIN_EPS = 1e-3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 16, 2
FD_B, FD_S, FD_H, FD_KV, FD_HD = 4, 64, 4, 2, 16
FD_POS_SCALAR = 40
FD_POS_ROWS = (5, 17, 40, 60)
FD_CASES = {  # cache, positions, queries a row, window, block_s
    "float_scalar": ("float", "scalar", 1, 0, None),
    "float_rows": ("float", "rows", 1, 0, None),
    "int8_rows": ("int8", "rows", 1, 0, None),
    "float_verify": ("float", "rows", 3, 0, None),
    "float_window": ("float", "rows", 1, 16, None),
    "float_stream": ("float", "rows", 1, 0, 8),
    "int8_stream": ("int8", "scalar", 1, 0, 8),
}
FD_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
CM_N = 1000
CODECS = ("int8", "elp4")


def flatten(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def unflatten(flat: dict, prefix: str, wrap) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = wrap(v)
    return out


def make_inputs(path: str) -> None:
    """The seeded numpy inputs of every case (the LM weights from the port's init)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import transformer

    rng = np.random.default_rng(7)
    f32 = np.float32
    inp = {
        "moe/x": rng.normal(size=(MOE_T, 32)).astype(f32),
        "moe/router": (rng.normal(size=(32, 8)) * 0.5).astype(f32),
        "moe/we1": (rng.normal(size=(8, 32, 64)) * 0.1).astype(f32),
        "moe/we3": (rng.normal(size=(8, 32, 64)) * 0.1).astype(f32),
        "moe/we2": (rng.normal(size=(8, 64, 32)) * 0.1).astype(f32),
        "fd/q": rng.normal(size=(FD_B, 3, FD_H, FD_HD)).astype(f32),
        "fd/ck": rng.normal(size=(FD_B, FD_S, FD_KV, FD_HD)).astype(f32),
        "fd/cv": rng.normal(size=(FD_B, FD_S, FD_KV, FD_HD)).astype(f32),
        "fd/ck8": rng.integers(-127, 128, size=(FD_B, FD_S, FD_KV, FD_HD)).astype(np.int8),
        "fd/cv8": rng.integers(-127, 128, size=(FD_B, FD_S, FD_KV, FD_HD)).astype(np.int8),
        "fd/ks": rng.uniform(0.005, 0.03, size=(FD_B, FD_S, FD_KV, 1)).astype(f32),
        "fd/vs": rng.uniform(0.005, 0.03, size=(FD_B, FD_S, FD_KV, 1)).astype(f32),
        "cm/x": (rng.normal(size=(WORLD, CM_N)) * np.exp(rng.normal(size=(WORLD, CM_N)))
                 ).astype(f32),
    }
    for model, kw in TRAIN_MODELS.items():
        params = transformer.init_params(ArchConfig(**kw), seed=3, device="cpu")
        inp.update({k: v.numpy() for k, v in flatten(params, f"train/{model}/params").items()})
    np.savez(path, **inp)


def _fd_args(inp, case):
    cache, pos, sq, window, block_s = FD_CASES[case]
    q = inp["fd/q"][:, :sq]
    ck, cv = (inp["fd/ck8"], inp["fd/cv8"]) if cache == "int8" else (inp["fd/ck"], inp["fd/cv"])
    ks, vs = (inp["fd/ks"], inp["fd/vs"]) if cache == "int8" else (None, None)
    p = np.int32(FD_POS_SCALAR) if pos == "scalar" else np.asarray(FD_POS_ROWS, np.int32)
    return q, ck, cv, ks, vs, p, window, block_s


# ---------------------------------------------------------------------------
# The JAX package (a subprocess with 4 fake CPU devices)
# ---------------------------------------------------------------------------
def jax_reference(in_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.configs.base import ArchConfig
    from repro.data.pipeline import LmDataset
    from repro.models import moe
    from repro.models.context import ParallelCtx
    from repro.models.flash_decode import flash_decode_attention
    from repro.optim import adamw
    from repro.optim import compress
    from repro.runtime import train_loop

    assert len(jax.devices()) == WORLD, jax.devices()
    inp = dict(np.load(in_path))
    res = {}

    # moe_ep on two meshes at two capacities, the dense oracle and the per-expert outputs
    p = {k: jnp.asarray(inp[f"moe/{k}"]) for k in ("router", "we1", "we3", "we2")}
    x = jnp.asarray(inp["moe/x"])
    base = ArchConfig(**MOE_KW)
    res["moe/dense"] = moe.moe_dense(p, x, base)
    h = jnp.broadcast_to(x[None], (base.n_experts, *x.shape))
    res["moe/expert_out"] = moe._expert_ffn(h, p["we1"], p["we3"], p["we2"], "swiglu")
    gates, topi = moe.router_gates(x, p["router"], base.topk)
    res["moe/gates"], res["moe/topi"] = gates, topi
    for mname, shape in MOE_MESHES.items():
        mesh = jax.make_mesh(shape, ("data", "model"))
        pctx = ParallelCtx(mesh=mesh, batch_axes=("data",), model_axis="model")
        n = shape[0] * shape[1]
        for cname, cf in MOE_CF.items():
            cfg = ArchConfig(**MOE_KW, moe_capacity_factor=cf)
            with mesh:
                res[f"moe/{mname}/{cname}/out"] = jax.jit(
                    lambda pp, xx, c=cfg, pc=pctx: moe.moe_ep(pp, xx, c, pc))(p, x)
            # each shard's slots, as moe.py computes them on its own tokens
            t = MOE_T // n
            for r in range(n):
                _, ti = moe.router_gates(x[r * t:(r + 1) * t], p["router"], cfg.topk)
                e_flat = ti.reshape(-1)
                order = jnp.argsort(e_flat, stable=True)
                e_sorted = e_flat[order]
                start = jnp.searchsorted(e_sorted, e_flat, side="left")
                rank_sorted = jnp.arange(t * cfg.topk) - start[order]
                slot = jnp.zeros((t * cfg.topk,), jnp.int32).at[order].set(
                    rank_sorted.astype(jnp.int32))
                cap = max(8, int(math.ceil(t * cfg.topk / cfg.n_experts * cf)))
                res[f"moe/{mname}/{cname}/slot{r}"] = slot
                res[f"moe/{mname}/{cname}/dropped{r}"] = slot >= cap

    # flash-decoding
    for mname, shape in FD_MESHES.items():
        mesh = jax.make_mesh(shape, ("data", "model"))
        pctx = ParallelCtx(mesh=mesh, batch_axes=("data",), model_axis="model",
                           flash_decode=True)
        for case in FD_CASES:
            q, ck, cv, ks, vs, pos, window, block_s = _fd_args(inp, case)
            fn = jax.jit(lambda q_, k_, v_, p_, ks_, vs_, w=window, bs=block_s, pc=pctx:
                         flash_decode_attention(q_, k_, v_, p_, pctx=pc, window=w, ks=ks_,
                                                vs=vs_, block_s=bs))
            with mesh:
                res[f"fd/{mname}/{case}/out"] = fn(
                    jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
                    None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs))

    # compressed_mean over a 4-device axis, and each rank's codes
    mesh = jax.make_mesh((WORLD,), ("data",))
    xs = jnp.asarray(inp["cm/x"])
    for codec in CODECS:
        fn = shard_map(lambda v, c=codec: compress.compressed_mean(v[0], "data", c)[None],
                       mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False)
        res[f"cm/{codec}/mean"] = fn(xs)
        quant = compress._quant_int8 if codec == "int8" else compress._quant_elp4
        for r in range(WORLD):
            res[f"cm/{codec}/codes{r}"], res[f"cm/{codec}/scales{r}"] = quant(xs[r])

    # two single-device train steps on the whole batch, each model
    for model, kw in TRAIN_MODELS.items():
        cfg = ArchConfig(**kw)
        params = unflatten(inp, f"train/{model}/params", jnp.asarray)
        setup = train_loop.TrainSetup(cfg=cfg, mesh=None,
                                      adamw_cfg=adamw.AdamWConfig(eps=TRAIN_EPS), **TRAIN)
        step = jax.jit(train_loop.make_train_step(setup))
        opt = adamw.init_state(params)
        ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
        for i in range(TRAIN_STEPS):
            batch = {k: jnp.asarray(v) for k, v in ds.np_batch(i).items()}
            params, opt, _, m = step(params, opt, None, batch)
            for key in ("loss", "lr", "gnorm"):
                res[f"train/{model}/{key}{i}"] = m[key]
        res.update(flatten(params, f"train/{model}/after"))
    np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})


# ---------------------------------------------------------------------------
# The port (one process a rank)
# ---------------------------------------------------------------------------
def rank_main(rank: int, world: int, store_path: str, in_path: str, out_dir: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.runtime import collectives
    from repro_torch.runtime.elastic import make_mesh

    inp = dict(np.load(in_path))
    meshes = {
        "2x2": make_mesh(target_model=2, device="cpu"),
        "1x4": make_mesh(target_model=4, device="cpu"),
        "4x1": make_mesh(target_model=1, device="cpu"),
        "2x1": make_mesh(devices=[0, 1], target_model=1, device="cpu"),
        "1x1": make_mesh(devices=[0], target_model=1, device="cpu"),
        "pod2x2x1": DeviceMesh("cpu", torch.arange(world).reshape(2, 2, 1),
                               mesh_dim_names=("pod", "data", "model")),
    }
    res = {"rank": rank}
    collectives.reset()
    for name, fn in (("moe", _port_moe), ("fd", _port_flash), ("cm", _port_compressed),
                     ("train", _port_train), ("layout", _port_layout), ("raises", _port_raises),
                     ("defaults", _port_defaults)):
        before = dict(collectives.ISSUED)
        fn(res, inp, meshes, out_dir)
        for kind, n in collectives.ISSUED.items():
            res[f"issued/{name}/{kind}"] = np.asarray(n - before.get(kind, 0))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _port_moe(res, inp, meshes, out_dir) -> None:
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import moe
    from repro_torch.models.context import ParallelCtx
    from repro_torch.runtime.sharding import batch_axes

    for mname in MOE_MESHES:
        mesh = meshes[mname]
        pctx = ParallelCtx(mesh=mesh, batch_axes=batch_axes(mesh), model_axis="model")
        m, nb, mr, d = pctx.model_size, pctx.batch_size, pctx.model_rank, pctx.batch_rank
        x = torch.from_numpy(inp["moe/x"]).chunk(nb)[d]  # this rank's batch slice
        p = {"router": torch.from_numpy(inp["moe/router"])}
        for k in ("we1", "we3", "we2"):
            p[k] = torch.from_numpy(inp[f"moe/{k}"]).chunk(m)[mr].clone()
        for cname, cf in MOE_CF.items():
            cfg = ArchConfig(**MOE_KW, moe_capacity_factor=cf)
            res[f"moe/{mname}/{cname}/out"] = moe.moe_apply(p, x, cfg, pctx)
            res[f"moe/{mname}/{cname}/row0"] = d * x.shape[0]
            shard = x.chunk(m)[mr]
            r = moe.ep_dispatch(shard, p["router"], cfg, m)
            res[f"moe/{mname}/{cname}/shard"] = d * m + mr
            res[f"moe/{mname}/{cname}/slot"] = r["slot"]
            res[f"moe/{mname}/{cname}/dropped"] = r["dropped"]


def _port_flash(res, inp, meshes, out_dir) -> None:
    import torch

    from repro_torch.models.context import ParallelCtx
    from repro_torch.models.flash_decode import batch_sharded, flash_decode_attention

    for mname in FD_MESHES:
        mesh = meshes[mname]
        pctx = ParallelCtx(mesh=mesh, batch_axes=("data",), model_axis="model",
                           flash_decode=True)
        split = batch_sharded(FD_B, pctx)
        d, mr, m = pctx.batch_rank, pctx.model_rank, pctx.model_size

        def rows(a):
            return a.chunk(pctx.batch_size)[d] if split else a

        for case in FD_CASES:
            q, ck, cv, ks, vs, pos, window, block_s = _fd_args(inp, case)

            def local(a):
                return None if a is None else rows(torch.from_numpy(a)).chunk(m, dim=1)[mr]

            pos_t = torch.from_numpy(np.asarray(pos))
            out = flash_decode_attention(
                rows(torch.from_numpy(q)), local(ck), local(cv),
                rows(pos_t) if pos_t.ndim else pos_t, pctx=pctx, window=window, ks=local(ks),
                vs=local(vs), block_s=block_s)
            res[f"fd/{mname}/{case}/out"] = out
            res[f"fd/{mname}/{case}/row0"] = d * out.shape[0] if split else 0


def _port_compressed(res, inp, meshes, out_dir) -> None:
    import torch

    from repro_torch.models.context import ParallelCtx
    from repro_torch.optim import compress

    pctx = ParallelCtx(mesh=meshes["4x1"])
    x = torch.from_numpy(inp["cm/x"][pctx.batch_rank])
    for codec in CODECS:
        res[f"cm/{codec}/mean"] = compress.compressed_mean(x, pctx.batch_group, codec)
        quant = compress._quant_int8 if codec == "int8" else compress._quant_elp4
        res[f"cm/{codec}/codes"], res[f"cm/{codec}/scales"] = quant(x)
    res["cm/rank"] = pctx.batch_rank


def _params(inp, model="dense"):
    import torch

    return unflatten(inp, f"train/{model}/params", lambda a: torch.from_numpy(a.copy()))


def _port_train(res, inp, meshes, out_dir) -> None:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainSetup, init_opt_state, make_train_step

    for model, mname in TRAIN_CASES:
        mesh = meshes[mname]
        if mesh.get_coordinate() is None:
            continue
        cfg = ArchConfig(**TRAIN_MODELS[model])
        ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
        setup = TrainSetup(cfg=cfg, mesh=mesh, adamw_cfg=AdamWConfig(eps=TRAIN_EPS), **TRAIN)
        params = _params(inp, model)
        opt = init_opt_state(setup, params)
        key0 = f"train/{model}/{mname}"
        res[f"{key0}/m_wq_shape"] = np.asarray(opt["m"]["blocks"]["wq"].shape)
        step = make_train_step(setup)
        for i in range(TRAIN_STEPS):
            batch = shard_batch(ds.np_batch(i), mesh, device="cpu")
            params, opt, _, m = step(params, opt, None, batch)
            for key in ("loss", "lr", "gnorm"):
                res[f"{key0}/{key}{i}"] = m[key]
        res.update(flatten(params, f"{key0}/after"))


def _port_layout(res, inp, meshes, out_dir) -> None:
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import sharding as shr
    from repro_torch.runtime.elastic import gather, reshard
    from repro_torch.runtime.train_loop import TrainSetup, state_specs, train

    params = _params(inp)
    # reshard then gather: tensor-parallel specs on 2x2, ZeRO-1 over (pod, data)
    m22, pod = meshes["2x2"], meshes["pod2x2x1"]
    specs = shr.param_specs(params, m22)
    local = reshard(params, m22, specs)
    res["layout/wq_local_shape"] = np.asarray(local["blocks"]["wq"].shape)
    back = gather(local, m22, specs)
    res["layout/tp_round_trip"] = all(
        torch.equal(a, b) for a, b in zip(flatten(back, "").values(), flatten(params, "").values()))
    zspecs = shr.zero1_specs_tree(shr.param_specs(params, pod), params, pod)
    local = reshard(params, pod, zspecs)
    res["layout/embed_zero1_shape"] = np.asarray(local["embed"].shape)
    back = gather(local, pod, zspecs)
    res["layout/zero1_round_trip"] = all(
        torch.equal(a, b) for a, b in zip(flatten(back, "").values(), flatten(params, "").values()))

    # shard_batch on 2x2: this rank's rows of the global batch
    cfg = ArchConfig(**LM_KW)
    ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    res["layout/batch_tokens"] = shard_batch(ds.np_batch(0), m22, device="cpu")["tokens"]
    res["layout/batch_rank"] = m22.get_coordinate()[0]

    # a checkpoint saved by train() on 2x1 (ranks 0, 1), restored on 1x1 (rank 0)
    ckpt = os.path.join(out_dir, "ckpt")
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_fn=lambda _: None, device="cpu")
    adam = AdamWConfig(eps=TRAIN_EPS)
    m21, m11 = meshes["2x1"], meshes["1x1"]
    if m21.get_coordinate() is not None:
        setup = TrainSetup(cfg=cfg, mesh=m21, adamw_cfg=adam, **TRAIN)
        out = train(setup, steps=2, ckpt_dir=ckpt, ckpt_every=2, **kw)
        whole = gather(out["opt_state"], m21, state_specs(setup, out["params"])[1])
        res["ckpt/m_wq_local_rows"] = out["opt_state"]["m"]["blocks"]["wq"].shape[1]
    if m11.get_coordinate() is not None:
        setup = TrainSetup(cfg=cfg, mesh=m11, adamw_cfg=adam, **TRAIN)
        template = {"params": out["params"], "opt": whole}
        step, tree = CheckpointManager(ckpt).restore_latest(template)
        opt = reshard(tree["opt"], m11, state_specs(setup, tree["params"])[1])
        pairs = list(zip(flatten(tree["params"], "").values(),
                         flatten(out["params"], "").values()))
        pairs += list(zip(flatten(opt, "").values(), flatten(whole, "").values()))
        res["ckpt/step"] = step
        res["ckpt/equal"] = all(torch.equal(a, b) for a, b in pairs)
        resumed = train(setup, steps=4, ckpt_dir=ckpt, **kw)
        res["ckpt/resumed_losses"] = np.asarray(resumed["losses"])


def _port_raises(res, inp, meshes, out_dir) -> None:
    """What was the boundary of the ported mesh paths: the recurrent and enc-dec
    families on a model axis of more than one rank (ROADMAP item 4d, ported: an
    enc-dec loss under the (2, 2) context on whole weights, every product whole on
    each rank, beside the meshless loss); the engine over the 4 ranks of the
    data-only mesh serves, each rank its slot (item 4c)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import get_model
    from repro_torch.runtime.train_loop import TrainSetup
    from repro_torch.serve.engine import ServeEngine, ServeSetup

    cfg = ArchConfig(**LM_KW)
    m22 = meshes["2x2"]
    ssm = get_config("mamba2_780m").reduced()
    hybrid = get_config("recurrentgemma_2b").reduced()
    encdec = get_config("seamless_m4t_large_v2").reduced()
    reqs = [(np.arange(1 + i, 4 + 2 * i, dtype=np.int32) % cfg.vocab, 3 + i % 2)
            for i in range(6)]
    outs = ServeEngine(cfg, _params(inp), n_slots=4, max_len=12, mesh=meshes["4x1"]).serve(reqs)
    plain = ServeEngine(cfg, _params(inp), n_slots=4, max_len=12, mesh=None).serve(reqs)
    res["raises/engine_same"] = all(np.array_equal(a, b) for a, b in zip(outs, plain))
    res["raises/engine_tokens"] = np.concatenate(outs)
    eparams = get_model(encdec).init_params(encdec, 0, device="cpu")
    ebatch = {"tokens": torch.arange(8).reshape(2, 4) % encdec.vocab,
              "labels": torch.arange(1, 9).reshape(2, 4) % encdec.vocab,
              "frontend": torch.linspace(-1, 1, 2 * 4 * encdec.d_model).reshape(
                  2, 4, encdec.d_model)}

    def eloss(pctx):
        return float(get_model(encdec).loss_fn(eparams, encdec, ebatch, pctx=pctx))

    calls = {
        "ssm": lambda: TrainSetup(cfg=ssm, mesh=m22),
        "hybrid": lambda: ServeSetup(cfg=hybrid, mesh=m22, max_len=8, batch=4),
        "encdec": lambda: eloss(TrainSetup(cfg=cfg, mesh=m22).pctx()),
    }
    for name, call in calls.items():
        try:
            out = call()
            res[f"raises/{name}"] = ""
        except NotImplementedError as e:
            out, res[f"raises/{name}"] = None, str(e)
        if name == "encdec":
            res["raises/encdec_loss"] = np.float64(np.nan if out is None else out)
    res["raises/encdec_meshless_loss"] = np.float64(eloss(None))


def _port_defaults(res, inp, meshes, out_dir) -> None:
    """The defaults inside a group of 4 ranks: ``ServeEngine``'s ``mesh="auto"``
    lays the elastic mesh over every rank (the model axis' target 16, halved to
    4) and serves the meshless engine's tokens, and the train launcher's default
    model axis trains tensor parallel over every rank."""
    import torch.distributed as dist

    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(ArchConfig(**LM_KW), _params(inp), n_slots=1, max_len=8)
    mesh = eng.stats()["mesh"]
    res["defaults/serve_mesh"] = np.asarray([mesh["data"], mesh["model"]])
    res["defaults/serve_tokens"] = eng.serve([(np.arange(1, 4, dtype=np.int32), 3)])[0]
    res["defaults/serve_meshless_tokens"] = ServeEngine(
        ArchConfig(**LM_KW), _params(inp), n_slots=1, max_len=8, mesh=None).serve(
        [(np.arange(1, 4, dtype=np.int32), 3)])[0]
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())  # as torchrun sets it
    out = launch_train.main(["--arch", "qwen3_8b", "--smoke", "--device", "cpu", "--steps", "1",
                             "--batch", "4", "--seq", "8"])
    res["defaults/train_mesh"] = np.asarray([out["mesh"]["data"], out["mesh"]["model"]])
    res["defaults/train_losses"] = np.asarray(out["losses"])


if __name__ == "__main__":
    if sys.argv[1] != "jax":
        raise SystemExit("usage: python tests/torch_mesh_ranks.py jax IN OUT")
    jax_reference(sys.argv[2], sys.argv[3])
