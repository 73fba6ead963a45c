"""Rank bodies and the JAX reference of ``tests/test_torch_tp_recurrent.py``.

The same numpy inputs (:func:`make_inputs`: the port's seeded weights of an
``ssm``, a ``hybrid`` and an ``audio`` config as numpy, their a4 trees with
float activations from the port's ``api.quantize``, token batches and frame
embeddings) go to two runs:

* :func:`jax_reference`, run as ``python tests/torch_tp_recurrent_ranks.py jax
  IN OUT`` in a subprocess that sees 4 fake CPU devices: for the ``ssm`` and
  ``hybrid`` configs the JAX package's GSPMD-sharded ``ServeSetup`` step on a
  ``(1, 4)`` or ``(2, 2)`` mesh of ``Auto`` axes; for the ``audio`` config the
  model's own ``prefill``/``decode_step``, jitted on parameters placed under
  ``shr.param_specs`` (the reference's ``ServeSetup`` decode step fails for the
  enc-dec families: ROADMAP.md, reference-side caveats); the prefill and 4
  greedy decode steps, each step's logits; and 2 train steps of each trained
  config (two more whose widths the model axis does not divide) on one device
  on the whole batch;
* :func:`rank_main`, the body of each of 4 ``gloo`` ranks: the port's
  ``ServeSetup`` over the same meshes of ranks (each rank on its rows and its
  blocks of the parameters and the state, the steps by hand and through
  ``static_generate``), ``TrainSetup`` on ``(1, 4)`` for each config and on
  ``(2, 2)`` with ``seq_parallel`` for the ``audio`` one, and the launchers on
  the reduced mamba2 config; each rank writes what it got.

Every key of the result files is a flat string.
"""
import os
import sys

import numpy as np

from torch_tp_ranks import SSM, flatten, packed_tree, unflatten

WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
STEPS = 4  # greedy decode steps after the prefill
B, S = 4, 10  # the hybrid's prompt passes its window of 8, and its ring wraps
FRAMES = 6
CONFIGS = {
    # 8 SSD heads; in_proj's 296 columns split across the z | x | B | C | dt segments
    "ssm": SSM,
    # rec, rec, attn; one KV head, split by wk's column block and shared
    "hybrid": dict(name="tp-hybrid", family="hybrid", n_layers=3, d_model=64, n_heads=4,
                   n_kv_heads=1, d_ff=128, vocab=64, head_dim=16, mlp_kind="geglu",
                   period=("rec", "rec", "attn"), window=8, lru_width=64, conv_width=4,
                   sub_quadratic=True, dtype_str="float32"),
    # a vocab that divides neither axis: the embedding and head split the features
    "audio": dict(name="tp-audio", family="audio", n_layers=2, n_dec_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=4, d_ff=128, vocab=63, head_dim=16, mlp_kind="gelu",
                  dtype_str="float32"),
}
FAMILIES = tuple(CONFIGS)
# trained only: widths that the model axis of 4 does not divide, so the rules keep
# mamba2's conv (162 channels) and the RG-LRU's channels (66) whole on every rank
CONFIGS["ssm_odd"] = dict(SSM, name="tp-ssm-odd", ssm_state=17)
CONFIGS["hybrid_odd"] = dict(CONFIGS["hybrid"], name="tp-hybrid-odd", lru_width=66)
# float weights on both meshes, the a4 codes with float activations on (1, 4)
SERVE_RUNS = [(fam, scheme, mesh) for fam in FAMILIES
              for scheme, meshes in (("float", ("1x4", "2x2")), ("a4", ("1x4",)))
              for mesh in meshes]
MAX_LEN = S + STEPS + 1
TRAIN_RUNS = ([(fam, "1x4", False) for fam in FAMILIES + ("ssm_odd", "hybrid_odd")]
              + [("audio", "2x2", True)])
TRAIN_FAMILIES = tuple(dict.fromkeys(fam for fam, _, _ in TRAIN_RUNS))
TRAIN = dict(lr_peak=1e-2, warmup=0, total_steps=10, remat=True)
TRAIN_EPS = 1e-3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 16, 2


def make_inputs(path: str) -> None:
    """The seeded numpy inputs of every case (the weights from the port's init)."""
    from repro_torch import api
    from repro_torch.configs.base import ArchConfig
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.models import get_model

    rng = np.random.default_rng(13)
    inp = {}
    for fam, kw in CONFIGS.items():
        cfg = ArchConfig(**kw)
        params = get_model(cfg).init_params(cfg, seed=7, device="cpu")
        inp.update({k: v.numpy() for k, v in flatten(params, f"params/{fam}").items()})
        inp[f"tokens/{fam}"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        if cfg.family == "audio":
            inp[f"frontend/{fam}"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
        if fam not in FAMILIES:
            continue
        packed = api.quantize(cfg, params, api.QuantScheme(fmt="elp_bsd_a4"), device="cpu").params
        for key, leaf in flatten(packed, f"a4/{fam}").items():
            if isinstance(leaf, PackedWeight):
                inp[f"{key}/codes"], inp[f"{key}/sf"] = leaf.codes.numpy(), leaf.sf.numpy()
                inp[f"{key}/meta"] = np.asarray([leaf.shape[0], leaf.shape[1], leaf.nibble, 0],
                                                np.int64)
                inp[f"{key}/fmt"] = np.asarray(leaf.fmt_name)
            else:
                inp[key] = leaf.numpy()
    np.savez(path, **inp)


def _batch(inp, fam):
    batch = {"tokens": inp[f"tokens/{fam}"]}
    if f"frontend/{fam}" in inp:
        batch["frontend"] = inp[f"frontend/{fam}"]
    return batch


# ---------------------------------------------------------------------------
# The JAX package (a subprocess with 4 fake CPU devices)
# ---------------------------------------------------------------------------
def jax_reference(in_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs.base import ArchConfig
    from repro.data.pipeline import LmDataset
    from repro.kernels.ops import PackedWeight
    from repro.models import get_model
    from repro.optim import adamw
    from repro.runtime import sharding as shr
    from repro.runtime import train_loop
    from repro.serve.engine import ServeSetup, build_serve_fns

    assert len(jax.devices()) == WORLD, jax.devices()
    inp = dict(np.load(in_path))
    res = {}
    auto = (jax.sharding.AxisType.Auto,) * 2  # GSPMD's propagation (ROADMAP, reference caveats)
    meshes = {m: jax.make_mesh(shape, ("data", "model"), axis_types=auto)
              for m, shape in MESHES.items()}
    for fam, scheme, mname in SERVE_RUNS:
        cfg = ArchConfig(**CONFIGS[fam])
        api = get_model(cfg)
        params = (packed_tree(inp, fam, PackedWeight, jnp.asarray, float_act=True)
                  if scheme == "a4" else unflatten(inp, f"params/{fam}", jnp.asarray))
        batch = {k: jnp.asarray(v) for k, v in _batch(inp, fam).items()}
        mesh = meshes[mname]
        if cfg.family == "audio":
            # the model's own steps on parameters placed under the rules
            pspecs = shr.param_specs(jax.eval_shape(lambda: params), mesh)
            params = jax.device_put(params, shr.named(mesh, pspecs))
            prefill = jax.jit(lambda p, b, c: api.prefill(p, cfg, b, c))
            decode = jax.jit(lambda p, t, c, pos: api.decode_step(p, cfg, t, c, pos))
        else:
            setup = ServeSetup(cfg=cfg, mesh=mesh, max_len=MAX_LEN, batch=B)
            prefill, decode = build_serve_fns(setup, api, aparams=jax.eval_shape(lambda: params))
        logits, cache = prefill(params, batch, api.init_cache(cfg, B, MAX_LEN))
        # the decode step's token sharding, as the ServeSetup step's jit declares it
        tok_sharding = NamedSharding(mesh, shr.input_spec((B, 1), mesh))
        key, toks = f"serve/{fam}/{scheme}/{mname}", []
        for i in range(STEPS + 1):
            res[f"{key}/logits{i}"] = logits[:, -1]
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            toks.append(tok)
            if i < STEPS:
                logits, cache = decode(params, jax.device_put(tok, tok_sharding), cache,
                                       jnp.int32(S + i))
        res[f"{key}/tokens"] = jnp.concatenate(toks, axis=1)

    # two train steps of each config on one device on the whole batch
    for fam in TRAIN_FAMILIES:
        cfg = ArchConfig(**CONFIGS[fam])
        params = unflatten(inp, f"params/{fam}", jnp.asarray)
        setup = train_loop.TrainSetup(cfg=cfg, mesh=None,
                                      adamw_cfg=adamw.AdamWConfig(eps=TRAIN_EPS), **TRAIN)
        step = jax.jit(train_loop.make_train_step(setup))
        opt = adamw.init_state(params)
        ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
        for i in range(TRAIN_STEPS):
            b = {k: jnp.asarray(v) for k, v in ds.np_batch(i).items()}
            params, opt, _, m = step(params, opt, None, b)
            for k in ("loss", "lr", "gnorm"):
                res[f"train/{fam}/{k}{i}"] = m[k]
        res.update(flatten(params, f"train/{fam}/after"))
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
    meshes = {"1x4": make_mesh(target_model=4, device="cpu"),
              "2x2": make_mesh(target_model=2, device="cpu")}
    res = {"rank": rank}
    for name, fn in (("serve", _port_serve), ("train", _port_train), ("launch", _port_launchers)):
        collectives.reset()
        fn(res, inp, meshes)
        for kind, n in collectives.ISSUED.items():
            res[f"issued/{name}/{kind}"] = np.asarray(n)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _params(inp, fam):
    import torch

    return unflatten(inp, f"params/{fam}", lambda a: torch.from_numpy(a.copy()))


def _issued_since(before: dict) -> dict:
    from repro_torch.runtime import collectives

    return {k: n - before.get(k, 0) for k, n in collectives.ISSUED.items()}


def _port_serve(res, inp, meshes) -> None:
    """Each run's prefill and decode steps through ``ServeSetup``'s pieces (the
    rank's rows and blocks), each step's logits and each call's collectives
    recorded; ``static_generate``; the rank's blocks of the parameters and state."""
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.models import get_model
    from repro_torch.runtime import collectives
    from repro_torch.serve.engine import ServeSetup, build_serve_fns, static_generate

    for fam, scheme, mname in SERVE_RUNS:
        cfg = ArchConfig(**CONFIGS[fam])
        api = get_model(cfg)
        params = (packed_tree(inp, fam, PackedWeight, lambda a: torch.from_numpy(a.copy()),
                              float_act=True) if scheme == "a4" else _params(inp, fam))
        batch = {k: torch.from_numpy(v) for k, v in _batch(inp, fam).items()}
        setup = ServeSetup(cfg=cfg, mesh=meshes[mname], max_len=MAX_LEN, batch=B)
        lo, hi = setup.rows()
        local = {k: v[lo:hi] for k, v in batch.items()}
        lp, cache = setup.layout(params, api.init_cache(cfg, hi - lo, MAX_LEN, device="cpu"))
        prefill, decode = build_serve_fns(setup, api)
        key = f"serve/{fam}/{scheme}/{mname}"
        before = dict(collectives.ISSUED)
        logits, cache = prefill(lp, local, cache)
        for kind, n in _issued_since(before).items():
            res[f"{key}/prefill_issued/{kind}"] = n
        before = dict(collectives.ISSUED)
        toks = []
        for i in range(STEPS + 1):
            res[f"{key}/logits{i}"] = logits[:, -1]
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks.append(tok)
            if i < STEPS:
                logits, cache = decode(lp, tok, cache, S + i)
        for kind, n in _issued_since(before).items():
            res[f"{key}/steps_issued/{kind}"] = n
        res[f"{key}/tokens"] = torch.cat(toks, dim=1)
        res[f"{key}/row0"] = lo
        res[f"{key}/generated"] = static_generate(setup, params, batch, STEPS + 1)
        if scheme == "float":
            for name, leaf in flatten(lp, "params").items():
                res[f"{key}/shape/{name}"] = np.asarray(leaf.shape)
            state = cache[0] if cfg.family == "audio" else cache
            tree = dict(zip(("conv", "ssd"), state)) if cfg.family == "ssm" else state
            for name, leaf in tree.items():
                res[f"{key}/state/{name}"] = np.asarray(leaf.shape)


def _port_train(res, inp, meshes) -> None:
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

    for fam, mname, sp in TRAIN_RUNS:
        cfg = ArchConfig(**CONFIGS[fam])
        mesh = meshes[mname]
        key0 = f"train/{fam}/{mname}/{'sp' if sp else 'tp'}"
        setup = TrainSetup(cfg=cfg, mesh=mesh, adamw_cfg=AdamWConfig(eps=TRAIN_EPS),
                           seq_parallel=sp, **TRAIN)
        whole = _params(inp, fam)
        params, opt = local_params(setup, whole), init_opt_state(setup, whole)
        step = make_train_step(setup)
        ds = LmDataset(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
        before = dict(collectives.ISSUED)
        for i in range(TRAIN_STEPS):
            params, opt, _, m = step(params, opt, None, shard_batch(ds.np_batch(i), mesh,
                                                                     device="cpu"))
            for k in ("loss", "lr", "gnorm"):
                res[f"{key0}/{k}{i}"] = m[k]
        for kind, n in _issued_since(before).items():
            res[f"{key0}/issued/{kind}"] = n
        res.update(flatten(gather(params, mesh, shr.param_specs(whole, mesh)), f"{key0}/after"))


def _port_launchers(res, inp, meshes) -> None:
    """The launchers inside the group of 4 ranks on the reduced mamba2 config: the
    default model axis (16, halved to 4) trains and serves ``--static`` over it."""
    import torch.distributed as dist

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    os.environ["WORLD_SIZE"] = str(dist.get_world_size())  # as torchrun sets it
    out = launch_train.main(["--arch", "mamba2_780m", "--smoke", "--device", "cpu", "--steps",
                             "1", "--batch", "4", "--seq", "8"])
    res["launch/train_mesh"] = np.asarray([out["mesh"]["data"], out["mesh"]["model"]])
    res["launch/train_losses"] = np.asarray(out["losses"])
    out = launch_serve.main(["--arch", "mamba2_780m", "--smoke", "--device", "cpu", "--static",
                             "--prompt-len", "8", "--max-new", "3"])
    res["launch/serve_tokens"] = out["tokens"]


if __name__ == "__main__":
    if sys.argv[1] != "jax":
        raise SystemExit("usage: python tests/torch_tp_recurrent_ranks.py jax IN OUT")
    jax_reference(sys.argv[2], sys.argv[3])


# ---------------------------------------------------------------------------
# Two ranks that share one card (``tests/test_torch_mesh_gpu.py``)
# ---------------------------------------------------------------------------
GPU_ARCHS = ("mamba2_780m", "recurrentgemma_2b", "seamless_m4t_large_v2")


def gpu_rank_main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One of two ranks on ``cuda:0`` over a ``gloo`` group and its ``(1, 2)`` mesh:
    each family's reduced config (float32), a4 codes, ``static_generate`` without
    and with the mesh (tokens, launches per route), and with the mesh every
    kernel call's output held against its plain version on the call's own inputs
    (the sharded shapes)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    import repro_torch.kernels.ops as ops_mod
    import repro_torch.models.transformer as transformer
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul, elp_bsd_matmul_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul, fused_decode_matmul_plain
    from repro_torch.models import get_model
    from repro_torch.runtime import collectives
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.serve.engine import ServeSetup, static_generate

    def launches():
        return {f"{k.__name__}/{r}": n for k in (elp_bsd_matmul, fused_decode_matmul,
                                                 flash_attention)
                for r, n in k.launches_by_route.items()}

    held = {}

    def holding(kernel, plain, name):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            if name == "flash_attention":
                want = plain(*args[:3], causal=kw.get("causal", True),
                             q_offset=kw.get("q_offset", 0))
            else:
                want = plain(*args, **kw)
            err = float((out.float() - want.float()).abs().max() / want.float().abs().max())
            held[name] = max(held.get(name, 0.0), err)
            return out
        return call

    mesh = make_mesh(target_model=world)
    rng = np.random.default_rng(3)
    res = {}
    for arch in GPU_ARCHS:
        cfg = get_config(arch).reduced()
        params = get_model(cfg).init_params(cfg, seed=2, device="cuda")
        packed = api.quantize(cfg, params, api.QuantScheme(fmt="elp4"), device="cuda").params
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).cuda()}
        if cfg.family in ("encdec", "audio"):
            batch["frontend"] = torch.from_numpy(
                rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)).cuda()
        for name, m in (("meshless", None), ("tp", mesh)):
            before = launches()
            collectives.reset()
            setup = ServeSetup(cfg=cfg, mesh=m, max_len=MAX_LEN, batch=B)
            saved = (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul,
                     transformer.flash_attention)
            if m is not None:
                held.clear()
                ops_mod.elp_bsd_matmul = holding(elp_bsd_matmul, elp_bsd_matmul_plain,
                                                 "elp_bsd_matmul")
                ops_mod.fused_decode_matmul = holding(fused_decode_matmul,
                                                      fused_decode_matmul_plain,
                                                      "fused_decode_matmul")
                transformer.flash_attention = holding(flash_attention, flash_attention_plain,
                                                      "flash_attention")
            try:
                res[f"{arch}/{name}/tokens"] = static_generate(setup, packed, batch, STEPS + 1)
            finally:
                (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul,
                 transformer.flash_attention) = saved
            torch.cuda.synchronize()
            after = launches()
            for k in after:
                res[f"{arch}/{name}/launches/{k}"] = after[k] - before[k]
            res[f"{arch}/{name}/all_reduce"] = collectives.ISSUED["all_reduce"]
        for k, err in held.items():
            res[f"{arch}/held/{k}"] = err
        everyone = [None] * world
        dist.all_gather_object(everyone, res[f"{arch}/tp/tokens"].tolist())
        res[f"{arch}/ranks_same"] = all(e == everyone[0] for e in everyone)
    np.savez(os.path.join(out_dir, f"gpu_rank{rank}.npz"),
             **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()
