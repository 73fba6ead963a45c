"""Rank bodies and the JAX reference of ``tests/test_torch_tensor_parallel.py``.

The same numpy inputs (:func:`make_inputs`: the port's seeded weights as
numpy, the a4 tree with static 8-bit activation scales that the port's
``api.quantize`` makes of the dense weights, token batches, patch
embeddings and static KV scales) go to two runs:

* :func:`jax_reference`, run as ``python tests/torch_tp_ranks.py jax IN OUT``
  in a subprocess that sees 4 fake CPU devices: the JAX package's jitted,
  GSPMD-sharded serving step (``ServeSetup`` on a ``(1, 4)`` or ``(2, 2)``
  mesh of ``Auto`` axes, the prefill and 4 greedy decode steps, each step's
  logits) on the float and the packed trees, the dense static int8 cache,
  the bf16 gap of its ``(1, 4)`` step against its meshless one,
  ``static_generate`` for an ``ssm`` config (meshless; the ssm family on a
  model axis is ``tests/test_torch_tp_recurrent.py``'s), and 2 train steps on
  one device on the whole batch;
* :func:`rank_main`, the body of each of 4 ``gloo`` ranks started by
  ``torch.multiprocessing.spawn``: the port's ``ServeSetup`` over the same
  meshes of ranks (each rank on its rows and its blocks of the parameters,
  the same steps by hand and through ``static_generate``), the bf16 gap of
  its ``(1, 4)`` run against its meshless one, the data-only ``(4, 1)``
  ``batch_generate`` of the ``ssm`` config, ``TrainSetup`` on
  ``(1, 4)`` and ``(2, 2)`` with and without ``seq_parallel``, a checkpoint
  written by ``train`` on ``(2, 2)`` and restored on ``(1, 1)``, and a
  row-parallel packed product at an odd K; each rank writes what it got.

The test compares the two. Every key of the result files is a flat string.
"""
import os
import sys

import numpy as np

WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
STEPS = 4  # greedy decode steps after the prefill
B, S = 4, 8
BASE = dict(family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            head_dim=16, dtype_str="float32")
CONFIGS = {
    # 2 KV heads: their column block splits a head over 4 ranks
    "dense": dict(BASE, name="tp-dense", vocab=64, qk_norm=True),
    # a vocab that divides neither axis: the embedding and head split the features
    "dense_v63": dict(BASE, name="tp-v63", vocab=63),
    "moe": dict(BASE, name="tp-moe", family="moe", vocab=64, d_ff=32, n_experts=8, topk=2,
                moe_capacity_factor=8.0),
    "vlm": dict(BASE, name="tp-vlm", family="vlm", vocab=64, frontend_tokens=4),
}
SSM = dict(name="tp-ssm", family="ssm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
           vocab=64, head_dim=16, tie_embeddings=True, ssm_state=16, expand=2, ssm_head_dim=16,
           conv_width=4, sub_quadratic=True, dtype_str="float32")
# (config, scheme, cache, moe_impl, meshes): float weights and activations, a4 codes
# with static 8-bit activations and the same codes with float activations, the
# dense static int8 cache. Each case runs on the meshes that exercise it (each one
# is a sharded compile of the reference's step).
SERVE_CASES = {
    "dense": ("dense", "float", "dense", "ep", ("1x4", "2x2")),
    "dense_v63": ("dense_v63", "float", "dense", "ep", ("1x4",)),
    "moe_ep": ("moe", "float", "dense", "ep", ("1x4", "2x2")),
    "moe_dense": ("moe", "float", "dense", "dense", ("2x2",)),
    "vlm": ("vlm", "float", "dense", "ep", ("1x4",)),
    "dense_a4_static": ("dense", "a4", "dense", "ep", ("1x4", "2x2")),
    "dense_a4_float": ("dense", "a4_float", "dense", "ep", ("1x4", "2x2")),
    "dense_int8_cache": ("dense", "float", "static", "ep", ("1x4",)),
}
SERVE_RUNS = [(case, mesh) for case, spec in SERVE_CASES.items() for mesh in spec[4]]
MAX_LEN = S + CONFIGS["vlm"]["frontend_tokens"] + STEPS + 1
TRAIN_CASES = (("1x4", False), ("1x4", True), ("2x2", False), ("2x2", True))
TRAIN = dict(lr_peak=1e-2, warmup=0, total_steps=10, remat=True)
TRAIN_EPS = 1e-3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 16, 2
ODD_K, ODD_N = 63, 32  # a row-parallel packed product whose nibble pad row is the last rank's
# the bf16 gap: a4 codes with float activations in a bfloat16 dense config wide and
# deep enough for float32 sums in another order to flip bf16 roundings, teacher-forced
# on the meshless run's tokens, (1, 4) against meshless
BF16 = dict(BASE, name="tp-bf16", n_layers=4, d_model=256, n_heads=8, head_dim=32, d_ff=512,
            vocab=256, qk_norm=True)
BF16_MESH, BF16_STEPS = "1x4", 8


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
    """The seeded numpy inputs of every case (the weights from the port's init)."""
    import torch

    from repro_torch import api
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.configs.base import ArchConfig
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.models import get_model

    rng = np.random.default_rng(11)
    inp = {}
    for name, kw in {**CONFIGS, "ssm": SSM}.items():
        cfg = ArchConfig(**kw)
        params = get_model(cfg).init_params(cfg, seed=5, device="cpu")
        inp.update({k: v.numpy() for k, v in flatten(params, f"params/{name}").items()})
        inp[f"tokens/{name}"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        if cfg.frontend_tokens:
            inp[f"frontend/{name}"] = rng.normal(
                size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        if name == "dense":
            calib = rng.integers(0, cfg.vocab, (2, 2, S)).astype(np.int32)
            ks, vs = calibrate_kv_cache(params, cfg, torch.from_numpy(calib))
            inp["kv_scales/k"], inp["kv_scales/v"] = np.asarray(ks), np.asarray(vs)
            scheme = api.QuantScheme(fmt="elp_bsd_a4", act="static", act_bits=8)
            packed = api.quantize(cfg, params, scheme, calib_data=calib, device="cpu").params
            for key, leaf in flatten(packed, "a4/dense").items():
                if isinstance(leaf, PackedWeight):
                    inp[f"{key}/codes"], inp[f"{key}/sf"] = leaf.codes.numpy(), leaf.sf.numpy()
                    inp[f"{key}/meta"] = np.asarray([leaf.shape[0], leaf.shape[1], leaf.nibble,
                                                     leaf.act_bits or 0], np.int64)
                    inp[f"{key}/act_scale"] = np.float32(leaf.act_scale)
                    inp[f"{key}/fmt"] = np.asarray(leaf.fmt_name)
                else:
                    inp[key] = leaf.numpy()
    cfg = ArchConfig(**BF16)
    params = get_model(cfg).init_params(cfg, seed=5, device="cpu")
    packed = api.quantize(cfg, params, api.QuantScheme(fmt="elp_bsd_a4"), device="cpu").params
    for key, leaf in flatten(packed, "a4/bf16").items():
        if isinstance(leaf, PackedWeight):
            inp[f"{key}/codes"], inp[f"{key}/sf"] = leaf.codes.numpy(), leaf.sf.numpy()
            inp[f"{key}/meta"] = np.asarray([leaf.shape[0], leaf.shape[1], leaf.nibble, 0],
                                            np.int64)
            inp[f"{key}/fmt"] = np.asarray(leaf.fmt_name)
        else:
            inp[key] = leaf.numpy()
    inp["tokens/bf16"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    inp["odd/x"] = rng.normal(size=(3, ODD_K)).astype(np.float32)
    inp["odd/w"] = (rng.normal(size=(ODD_K, ODD_N)) / 8).astype(np.float32)
    np.savez(path, **inp)


def packed_tree(inp, name, packed_cls, wrap, float_act: bool = False) -> dict:
    """The a4 tree ``name`` of the inputs, packed weights as ``packed_cls`` (the
    JAX package's or the port's ``PackedWeight``) of ``wrap``-ped arrays; with
    ``float_act`` without their static activation quantizers (float activations
    into the same codes)."""
    prefix = f"a4/{name}"
    leaves = {}
    for key, v in inp.items():
        if not key.startswith(prefix + "/"):
            continue
        head, _, last = key.rpartition("/")
        if last == "meta":
            k, n, nibble, bits = (int(a) for a in v)
            act = {} if float_act else dict(act_scale=float(inp[f"{head}/act_scale"]),
                                            act_bits=bits or None)
            leaves[head] = packed_cls(
                codes=wrap(inp[f"{head}/codes"]), sf=wrap(inp[f"{head}/sf"]),
                fmt_name=str(inp[f"{head}/fmt"]), nibble=bool(nibble), shape=(k, n), **act)
        elif last not in ("codes", "sf", "act_scale", "fmt"):
            leaves[key] = wrap(v)
    return unflatten(leaves, prefix, lambda a: a)


def case_params(inp, cname, scheme, packed_cls, wrap) -> dict:
    """The tree of a serving case: float weights, or the a4 codes with their static
    activation scales (``"a4"``) or without them (``"a4_float"``)."""
    if scheme.startswith("a4"):
        return packed_tree(inp, cname, packed_cls, wrap, float_act=scheme == "a4_float")
    return unflatten(inp, f"params/{cname}", wrap)


def bf16_tree(tree, packed_cls, cast):
    """``tree`` with each float leaf outside its packed weights ``cast`` to bfloat16
    (the codes and their float32 scales as they are), as a bf16 model holds it."""
    if isinstance(tree, dict):
        return {k: bf16_tree(v, packed_cls, cast) for k, v in tree.items()}
    return tree if isinstance(tree, packed_cls) else cast(tree)


def _case_batch(inp, cfg_name):
    batch = {"tokens": inp[f"tokens/{cfg_name}"]}
    if f"frontend/{cfg_name}" in inp:
        batch["frontend"] = inp[f"frontend/{cfg_name}"]
    return batch


def _kv_scales(inp):
    return inp["kv_scales/k"], inp["kv_scales/v"]


# ---------------------------------------------------------------------------
# The JAX package (a subprocess with 4 fake CPU devices)
# ---------------------------------------------------------------------------
def jax_reference(in_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs.base import ArchConfig
    from repro.kernels.ops import PackedWeight
    from repro.data.pipeline import LmDataset
    from repro.models import get_model
    from repro.models import transformer
    from repro.optim import adamw
    from repro.runtime import sharding as shr
    from repro.runtime import train_loop
    from repro.serve.engine import ServeSetup, build_serve_fns, static_generate

    assert len(jax.devices()) == WORLD, jax.devices()
    inp = dict(np.load(in_path))
    res = {}
    auto = (jax.sharding.AxisType.Auto,) * 2  # GSPMD's propagation (ROADMAP, reference caveats)
    meshes = {m: jax.make_mesh(shape, ("data", "model"), axis_types=auto)
              for m, shape in MESHES.items()}
    for case, (cname, scheme, cache_kind, impl, mesh_names) in SERVE_CASES.items():
        cfg = ArchConfig(**CONFIGS[cname])
        params = case_params(inp, cname, scheme, PackedWeight, jnp.asarray)
        batch = {k: jnp.asarray(v) for k, v in _case_batch(inp, cname).items()}
        for mname in mesh_names:
            mesh = meshes[mname]
            setup = ServeSetup(cfg=cfg, mesh=mesh, max_len=MAX_LEN, batch=B, moe_impl=impl,
                               kv_bits=8 if cache_kind == "static" else 0)
            prefill, decode = build_serve_fns(setup, get_model(cfg),
                                              aparams=jax.eval_shape(lambda: params))
            if cache_kind == "static":
                cache = transformer.init_cache(cfg, B, MAX_LEN, kv_scales=tuple(
                    jnp.asarray(s) for s in _kv_scales(inp)))
            else:
                cache = get_model(cfg).init_cache(cfg, B, MAX_LEN)
            logits, cache = prefill(params, batch, cache)
            pos = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
            # the decode step's token sharding, as its jit declares it
            tok_sharding = NamedSharding(mesh, shr.input_spec((B, 1), mesh))
            toks = []
            for i in range(STEPS + 1):
                res[f"serve/{case}/{mname}/logits{i}"] = logits[:, -1]
                tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
                toks.append(tok)
                if i < STEPS:
                    logits, cache = decode(params, jax.device_put(tok, tok_sharding), cache,
                                           jnp.int32(pos + i))
            res[f"serve/{case}/{mname}/tokens"] = jnp.concatenate(toks, axis=1)

    # the bf16 gap of the GSPMD step against the meshless one, teacher-forced
    cfg = ArchConfig(**dict(BF16, dtype_str="bfloat16"))
    params = bf16_tree(case_params(inp, "bf16", "a4_float", PackedWeight, jnp.asarray),
                       PackedWeight, lambda a: a.astype(jnp.bfloat16))
    batch = {"tokens": jnp.asarray(inp["tokens/bf16"])}
    runs, max_len = {}, S + BF16_STEPS + 1
    for mname, mesh in (("meshless", None), (BF16_MESH, meshes[BF16_MESH])):
        setup = ServeSetup(cfg=cfg, mesh=mesh, max_len=max_len, batch=B)
        prefill, decode = build_serve_fns(setup, get_model(cfg),
                                          aparams=jax.eval_shape(lambda: params))
        logits, cache = prefill(params, batch, get_model(cfg).init_cache(cfg, B, max_len))
        outs = [logits[:, -1].astype(jnp.float32)]
        for i in range(BF16_STEPS):
            tok = (jnp.argmax(outs[-1], axis=-1)[:, None].astype(jnp.int32) if mesh is None
                   else res["bf16/tokens"][:, i:i + 1])
            if mesh is not None:
                tok = jax.device_put(tok, NamedSharding(mesh, shr.input_spec((B, 1), mesh)))
            logits, cache = decode(params, tok, cache, jnp.int32(S + i))
            outs.append(logits[:, -1].astype(jnp.float32))
        if mesh is None:
            res["bf16/tokens"] = jnp.stack([jnp.argmax(o, axis=-1) for o in outs[:-1]],
                                           axis=1).astype(jnp.int32)
        runs[mname] = outs
    res["bf16/gap"] = max(float(jnp.abs(a - b).max() / jnp.abs(b).max())
                          for a, b in zip(runs[BF16_MESH], runs["meshless"]))

    # the ssm config, meshless (a data-only mesh computes the same function)
    cfg = ArchConfig(**SSM)
    params = unflatten(inp, "params/ssm", jnp.asarray)
    setup = ServeSetup(cfg=cfg, mesh=None, max_len=S + STEPS + 1, batch=B)
    res["ssm/tokens"] = static_generate(setup, params, {"tokens": jnp.asarray(inp["tokens/ssm"])},
                                        STEPS + 1)

    # two train steps on one device on the whole batch
    cfg = ArchConfig(**CONFIGS["dense"])
    params = unflatten(inp, "params/dense", jnp.asarray)
    setup = train_loop.TrainSetup(cfg=cfg, mesh=None,
                                  adamw_cfg=adamw.AdamWConfig(eps=TRAIN_EPS), **TRAIN)
    step = jax.jit(train_loop.make_train_step(setup))
    opt = adamw.init_state(params)
    ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    for i in range(TRAIN_STEPS):
        b = {k: jnp.asarray(v) for k, v in ds.np_batch(i).items()}
        params, opt, _, m = step(params, opt, None, b)
        for key in ("loss", "lr", "gnorm"):
            res[f"train/{key}{i}"] = m[key]
    res.update(flatten(params, "train/after"))
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
    from repro_torch.runtime import collectives
    from repro_torch.runtime.elastic import make_mesh

    inp = dict(np.load(in_path))
    meshes = {
        "1x4": make_mesh(target_model=4, device="cpu"),
        "2x2": make_mesh(target_model=2, device="cpu"),
        "4x1": make_mesh(target_model=1, device="cpu"),
        "1x1": make_mesh(devices=[0], target_model=1, device="cpu"),
    }
    res = {"rank": rank}
    for name, fn in (("serve", _port_serve), ("bf16", _port_bf16_gap), ("ssm", _port_ssm),
                     ("train", _port_train),
                     ("ckpt", _port_ckpt), ("odd", _port_odd_k), ("launch", _port_launchers)):
        collectives.reset()
        fn(res, inp, meshes, out_dir)
        for kind, n in collectives.ISSUED.items():
            res[f"issued/{name}/{kind}"] = np.asarray(n)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _params(inp, name):
    import torch

    return unflatten(inp, f"params/{name}", lambda a: torch.from_numpy(a.copy()))


def _port_serve(res, inp, meshes, out_dir) -> None:
    """Each case's prefill and decode steps through ``ServeSetup``'s pieces (the
    rank's rows and blocks), each step's logits recorded; and ``static_generate``."""
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.models import get_model
    from repro_torch.runtime import collectives
    from repro_torch.serve.engine import ServeSetup, build_serve_fns, static_generate

    for case, (cname, scheme, cache_kind, impl, mesh_names) in SERVE_CASES.items():
        cfg = ArchConfig(**CONFIGS[cname])
        params = case_params(inp, cname, scheme, PackedWeight,
                             lambda a: torch.from_numpy(a.copy()))
        batch = {k: torch.from_numpy(v) for k, v in _case_batch(inp, cname).items()}
        kv_scales = _kv_scales(inp) if cache_kind == "static" else None
        for mname in mesh_names:
            setup = ServeSetup(cfg=cfg, mesh=meshes[mname], max_len=MAX_LEN, batch=B,
                               moe_impl=impl, kv_bits=8 if kv_scales else 0)
            api_ = get_model(cfg)
            lo, hi = setup.rows()
            local = {k: v[lo:hi] for k, v in batch.items()}
            cache = (api_.init_cache(cfg, hi - lo, MAX_LEN, kv_scales=kv_scales, device="cpu")
                     if kv_scales else api_.init_cache(cfg, hi - lo, MAX_LEN, device="cpu"))
            before = dict(collectives.ISSUED)
            lp, cache = setup.layout(params, cache)
            prefill, decode = build_serve_fns(setup, api_)
            logits, cache = prefill(lp, local, cache)
            pos = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
            toks = []
            for i in range(STEPS + 1):
                res[f"serve/{case}/{mname}/logits{i}"] = logits[:, -1]
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                toks.append(tok)
                if i < STEPS:
                    logits, cache = decode(lp, tok, cache, pos + i)
            for kind, n in collectives.ISSUED.items():
                res[f"serve/{case}/{mname}/issued/{kind}"] = n - before.get(kind, 0)
            res[f"serve/{case}/{mname}/tokens"] = torch.cat(toks, dim=1)
            res[f"serve/{case}/{mname}/row0"] = lo
            res[f"serve/{case}/{mname}/generated"] = static_generate(
                setup, params, batch, STEPS + 1, kv_scales=kv_scales)
            if case == "dense":
                res[f"serve/{case}/{mname}/wq_shape"] = np.asarray(lp["blocks"]["wq"].shape)
                res[f"serve/{case}/{mname}/cache_shape"] = np.asarray(cache["k"].shape)
            if case == "dense_a4_static":
                wo = lp["blocks"]["wo"]
                res[f"serve/{case}/{mname}/wo_local"] = np.asarray(
                    [wo.shape[0], wo.shape[1], wo.codes.shape[-2]])


def _port_bf16_gap(res, inp, meshes, out_dir) -> None:
    """The bf16 gap of the (1, 4) run against the port's meshless one: the a4 codes
    with float activations of :data:`BF16` in bfloat16, teacher-forced on the
    meshless run's greedy tokens (the JAX side measures its own)."""
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeSetup

    cfg = ArchConfig(**dict(BF16, dtype_str="bfloat16"))
    params = bf16_tree(case_params(inp, "bf16", "a4_float", PackedWeight,
                                   lambda a: torch.from_numpy(a.copy())),
                       PackedWeight, lambda t: t.to(torch.bfloat16))
    tokens = torch.from_numpy(inp["tokens/bf16"])
    runs, forced, max_len = {}, None, S + BF16_STEPS + 1
    for mname, mesh in (("meshless", None), (BF16_MESH, meshes[BF16_MESH])):
        setup = ServeSetup(cfg=cfg, mesh=mesh, max_len=max_len, batch=B)
        lp, cache = setup.layout(params, transformer.init_cache(cfg, B, max_len, device="cpu"))
        logits, cache = transformer.prefill(lp, cfg, tokens, cache, pctx=setup.pctx())
        outs = [logits[:, -1].float()]
        for i in range(BF16_STEPS):
            tok = (torch.argmax(outs[-1], -1)[:, None] if forced is None
                   else forced[:, i:i + 1])
            logits, cache = transformer.decode_step(lp, cfg, tok, cache, S + i,
                                                    pctx=setup.pctx())
            outs.append(logits[:, -1].float())
        if forced is None:
            forced = torch.stack([torch.argmax(o, -1) for o in outs[:-1]], dim=1)
        runs[mname] = outs
    res["bf16/tokens"] = forced
    res["bf16/gap"] = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(runs[BF16_MESH], runs["meshless"]))


def _port_ssm(res, inp, meshes, out_dir) -> None:
    """The ``ssm`` config through ``batch_generate`` on the data-only (4, 1) mesh."""
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve.engine import batch_generate

    cfg = ArchConfig(**SSM)
    res["ssm/tokens"] = batch_generate(cfg, _params(inp, "ssm"),
                                       {"tokens": torch.from_numpy(inp["tokens/ssm"])},
                                       STEPS + 1, mesh=meshes["4x1"], max_len=S + STEPS + 1)


def _port_train(res, inp, meshes, out_dir) -> None:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import collectives
    from repro_torch.runtime import sharding as shr
    from repro_torch.runtime.elastic import gather
    from repro_torch.runtime.train_loop import (
        TrainSetup,
        init_opt_state,
        local_params,
        make_train_step,
    )

    cfg = ArchConfig(**CONFIGS["dense"])
    ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    for mname, sp in TRAIN_CASES:
        mesh = meshes[mname]
        key0 = f"train/{mname}/{'sp' if sp else 'tp'}"
        setup = TrainSetup(cfg=cfg, mesh=mesh, adamw_cfg=AdamWConfig(eps=TRAIN_EPS),
                           seq_parallel=sp, **TRAIN)
        whole = _params(inp, "dense")
        params, opt = local_params(setup, whole), init_opt_state(setup, whole)
        step = make_train_step(setup)
        before = dict(collectives.ISSUED)
        for i in range(TRAIN_STEPS):
            params, opt, _, m = step(params, opt, None, shard_batch(ds.np_batch(i), mesh,
                                                                     device="cpu"))
            for key in ("loss", "lr", "gnorm"):
                res[f"{key0}/{key}{i}"] = m[key]
        for kind, n in collectives.ISSUED.items():
            res[f"{key0}/issued/{kind}"] = n - before.get(kind, 0)
        res[f"{key0}/wq_local"] = np.asarray(params["blocks"]["wq"].shape)
        res[f"{key0}/m_wq_local"] = np.asarray(opt["m"]["blocks"]["wq"].shape)
        res.update(flatten(gather(params, mesh, shr.param_specs(whole, mesh)), f"{key0}/after"))


def _port_ckpt(res, inp, meshes, out_dir) -> None:
    """A checkpoint written by ``train`` on (2, 2) (with ``seq_parallel``), restored
    on (1, 1) by rank 0: the whole parameters and optimizer state equal."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ArchConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.elastic import gather, reshard
    from repro_torch.runtime.train_loop import TrainSetup, state_specs, train

    cfg = ArchConfig(**CONFIGS["dense"])
    ckpt = os.path.join(out_dir, "ckpt")
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_fn=lambda _: None, device="cpu")
    adam = AdamWConfig(eps=TRAIN_EPS)
    m22, m11 = meshes["2x2"], meshes["1x1"]
    setup = TrainSetup(cfg=cfg, mesh=m22, adamw_cfg=adam, seq_parallel=True, **TRAIN)
    out = train(setup, steps=2, ckpt_dir=ckpt, ckpt_every=2, **kw)
    whole = gather(out["opt_state"], m22, state_specs(setup, out["params"])[1])
    if m11.get_coordinate() is None:
        return
    setup = TrainSetup(cfg=cfg, mesh=m11, adamw_cfg=adam, **TRAIN)
    step, tree = CheckpointManager(ckpt).restore_latest({"params": out["params"], "opt": whole})
    opt = reshard(tree["opt"], m11, state_specs(setup, tree["params"])[1])
    pairs = list(zip(flatten(tree["params"], "").values(), flatten(out["params"], "").values()))
    pairs += list(zip(flatten(opt, "").values(), flatten(whole, "").values()))
    res["ckpt/step"] = step
    res["ckpt/equal"] = all(torch.equal(a, b) for a, b in pairs)
    res["ckpt/n_leaves"] = len(pairs)


def _port_odd_k(res, inp, meshes, out_dir) -> None:
    """A nibble-packed ``[63, 32]`` weight resharded row-parallel (its packed rows
    over the model axis): each rank's logical K, and the float32 partial products
    summed over the ranks against the whole product."""
    import dataclasses

    import torch

    from repro_torch.kernels.ops import pack_weight, quantized_matmul
    from repro_torch.models.context import ParallelCtx
    from repro_torch.models.layers import TPInput, tp_full, tp_matmul
    from repro_torch.runtime.elastic import gather, reshard

    pw, _ = pack_weight(torch.from_numpy(inp["odd/w"]), "elp_bsd_a4")
    x = torch.from_numpy(inp["odd/x"])
    whole = quantized_matmul(x, pw, out_dtype=torch.float32)
    for mname in MESHES:
        mesh = meshes[mname]
        pctx = ParallelCtx(mesh=mesh)
        spec = {"w": dataclasses.replace(pw, codes=("model", None), sf=())}
        local = reshard({"w": pw}, mesh, spec)["w"]
        y, form = tp_matmul(TPInput(x, pctx), local, ODD_K, ODD_N, pctx)
        got = tp_full(y, form, pctx, torch.float32)
        res[f"odd/{mname}/local"] = np.asarray([local.shape[0], local.codes.shape[0]])
        res[f"odd/{mname}/form"] = form
        res[f"odd/{mname}/err"] = (got - whole).abs().max() / whole.abs().max()
        back = gather({"w": local}, mesh, spec)["w"]
        res[f"odd/{mname}/round_trip"] = (back.shape == pw.shape
                                          and torch.equal(back.codes, pw.codes))


def _port_launchers(res, inp, meshes, out_dir) -> None:
    """The launchers inside the group of 4 ranks: training with ``--seq-parallel``
    on the default model axis (16, halved to 4) and ``--static`` serving over it."""
    import torch.distributed as dist

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    os.environ["WORLD_SIZE"] = str(dist.get_world_size())  # as torchrun sets it
    out = launch_train.main(["--arch", "qwen3_8b", "--smoke", "--device", "cpu", "--steps", "1",
                             "--batch", "4", "--seq", "8", "--seq-parallel"])
    res["launch/train_mesh"] = np.asarray([out["mesh"]["data"], out["mesh"]["model"]])
    res["launch/train_losses"] = np.asarray(out["losses"])
    out = launch_serve.main(["--arch", "qwen3_8b", "--smoke", "--device", "cpu", "--static",
                             "--prompt-len", "8", "--max-new", "3"])
    res["launch/serve_tokens"] = out["tokens"]


if __name__ == "__main__":
    if sys.argv[1] != "jax":
        raise SystemExit("usage: python tests/torch_tp_ranks.py jax IN OUT")
    jax_reference(sys.argv[2], sys.argv[3])


# ---------------------------------------------------------------------------
# Two ranks that share one card (``tests/test_torch_mesh_gpu.py``)
# ---------------------------------------------------------------------------
def gpu_rank_main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One of two ranks on ``cuda:0`` over a ``gloo`` group and its ``(1, 2)`` mesh:
    reduced float32 qwen3, a4 codes, ``static_generate`` without and with the
    mesh (tokens, launches per route), then 3 train steps without the mesh and
    with it, with and without ``seq_parallel`` (losses)."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_decode import fused_decode_matmul
    from repro_torch.models import transformer
    from repro_torch.runtime import collectives
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.runtime.train_loop import (
        TrainSetup,
        init_opt_state,
        local_params,
        make_train_step,
    )
    from repro_torch.serve.engine import ServeSetup, static_generate

    def launches():
        return {f"{k.__name__}/{r}": n for k in (elp_bsd_matmul, fused_decode_matmul,
                                                 flash_attention)
                for r, n in k.launches_by_route.items()}

    mesh = make_mesh(target_model=world)
    cfg = dataclasses.replace(get_config("qwen3_8b").reduced(), dtype_str="float32")
    params = transformer.init_params(cfg, seed=2, device="cuda")
    packed = api.quantize(cfg, params, api.QuantScheme(fmt="elp4"), device="cuda").params
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, S)))
    res = {}
    for name, m in (("meshless", None), ("tp", mesh)):
        before = launches()
        collectives.reset()
        setup = ServeSetup(cfg=cfg, mesh=m, max_len=S + STEPS + 1, batch=B)
        res[f"{name}/tokens"] = static_generate(setup, packed, {"tokens": tokens}, STEPS + 1)
        torch.cuda.synchronize()
        after = launches()
        for k in after:
            res[f"{name}/launches/{k}"] = after[k] - before[k]
        res[f"{name}/all_reduce"] = collectives.ISSUED["all_reduce"]
    ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=B, seed=0)
    for name, m, sp in (("meshless", None, False), ("tp", mesh, False), ("sp", mesh, True)):
        collectives.reset()
        setup = TrainSetup(cfg=cfg, mesh=m, seq_parallel=sp, **TRAIN)
        whole = transformer.init_params(cfg, seed=1, device="cuda")
        p, opt, step = local_params(setup, whole), init_opt_state(setup, whole), \
            make_train_step(setup)
        losses = []
        for i in range(3):
            p, opt, _, mt = step(p, opt, None, shard_batch(ds.np_batch(i), m, device="cuda"))
            losses.append(float(mt["loss"]))
        res[f"train/{name}"] = np.asarray(losses)
        res[f"train/{name}/reduce_scatter"] = collectives.ISSUED["reduce_scatter"]
    np.savez(os.path.join(out_dir, f"gpu_rank{rank}.npz"),
             **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()
