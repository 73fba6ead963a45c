"""Rank bodies and the JAX reference of ``tests/test_torch_engine_ranks.py``.

The same numpy inputs (:func:`make_inputs`: the port's seeded weights of
reduced float32 qwen3, whose 2 KV heads do not divide 4, and olmoe as numpy,
static KV scales calibrated by the port, the a4 tree with static 8-bit
activations that the port's ``api.quantize`` makes of qwen3, and a staggered
mixed-length request trace, half of it behind one shared prefix) go to two
runs:

* :func:`jax_reference`, run as ``python tests/torch_engine_ranks.py jax IN
  OUT ARCH`` in a subprocess a model that sees 4 fake CPU devices: the JAX
  package's ``ServeEngine`` on ``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` meshes
  of ``Auto`` axes (:data:`JAX_RUNS`: the dense cache, the paged
  static-int8 cache, flash-decode, qwen3's a4 tree), and, with olmoe, one
  flash-decode ``decode_step`` a cache kind of qwen3 on ``(1, 4)``;
* :func:`rank_main`, the body of each of 4 ``gloo`` ranks started by
  ``torch.multiprocessing.spawn``: the port's ``ServeEngine`` over the same
  meshes of ranks (:data:`PORT_RUNS`, also ngram and model-draft speculative
  decoding) and without one, the decode steps over flash-decode's
  sequence-sharded cache, a rank given a different ``submit``, and the
  entry points inside the group (``launch.serve``'s engine path and
  ``QuantizedModel.serve(mesh="auto")``); each rank writes what it got.

The test compares the two. Every key of the result files is a flat string.
"""
import os
import sys

import numpy as np

WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
TARGET_MODEL = {"1x4": 4, "2x2": 2, "4x1": 1}
ARCHS = ("qwen3_8b", "olmoe_1b_7b")
N_SLOTS, MAX_LEN, PAGE = 4, 16, 4
# (prompt length, new tokens, behind the shared prefix): at most 8 prompt tokens
# and 4 rows a step, so the expert-parallel capacity (at least 8 a bucket) drops
# nothing and the meshless dense MoE is the same function; 6 requests into 4
# slots, so slots are reused. Two prompt lengths, and a shared prompt's suffix of
# one of them, keep the reference's compiles few.
TRACE = ((8, 5, True), (8, 4, False), (4, 7, False), (8, 6, True), (4, 3, False),
         (8, 5, True))
ARRIVALS = (0, 0, 1, 1, 2, 3)
PREFIX = 4  # one page
SPEC_K = 3
# run -> (engine options, the meshes it runs on, the JAX run it is held against):
# speculative decoding is token-identical to plain serving, so the ngram and
# model-draft runs are held against the JAX dense run.
PORT_RUNS = {
    "dense": ({}, ("1x4", "2x2", "4x1"), "dense"),
    "paged": ({"kv_cache": "paged", "page_size": PAGE}, ("1x4", "2x2", "4x1"), "paged"),
    "ngram": ({"spec_k": SPEC_K, "spec_draft": "ngram"}, ("1x4", "2x2", "4x1"), "dense"),
    "draft": ({"spec_k": SPEC_K, "spec_draft": "model"}, ("1x4", "2x2", "4x1"), "dense"),
    "flash": ({"flash_decode": True}, ("1x4", "2x2"), "flash"),
}
JAX_RUNS = {
    "dense": ({}, ("1x4", "2x2", "4x1")),
    "paged": ({"kv_cache": "paged", "page_size": PAGE}, ("1x4", "2x2", "4x1")),
    "flash": ({"flash_decode": True}, ("1x4", "2x2")),
}
# olmoe (a heavier compile of the expert exchange) is held on fewer meshes
OLMOE_MESHES = {"dense": ("1x4", "2x2", "4x1"), "paged": ("2x2",), "ngram": ("1x4",),
                "draft": ("4x1",), "flash": ("1x4",)}


def meshes_of(arch: str, run: str, meshes: tuple) -> tuple:
    return OLMOE_MESHES[run] if arch == "olmoe_1b_7b" else meshes
A4_MESH = "1x4"  # the a4 tree with static 8-bit activations, qwen3 only
FD_CACHES = ("dense", "quant")  # flash-decode decode steps on (1, 4)
FD_PROMPT, FD_STEPS, FD_VERIFY = 5, 2, 3
DIVERGE_AT = 2  # the request that rank 3 submits with one more new token


def config(arch: str):
    """The port's reduced float32 config of ``arch`` (the JAX side builds its own
    from the same registry entry)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), dtype_str="float32")


def requests(vocab: int, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, PREFIX)
    out = []
    for n, new, shared in TRACE:
        tail = rng.integers(0, vocab, n - PREFIX if shared else n)
        prompt = np.concatenate([prefix, tail]) if shared else tail
        out.append((prompt.astype(np.int32), new))
    return out


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
    """The seeded numpy inputs of every run (the weights from the port's init)."""
    import torch

    from repro_torch import api
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.models import get_model

    inp = {}
    rng = np.random.default_rng(11)
    for arch in ARCHS:
        cfg = config(arch)
        params = get_model(cfg).init_params(cfg, seed=5, device="cpu")
        inp.update({k: v.numpy() for k, v in flatten(params, f"params/{arch}").items()})
        calib = rng.integers(0, cfg.vocab, (2, 2, 8)).astype(np.int32)
        ks, vs = calibrate_kv_cache(params, cfg, torch.from_numpy(calib))
        inp[f"kv_scales/{arch}/k"], inp[f"kv_scales/{arch}/v"] = np.asarray(ks), np.asarray(vs)
        for i, (prompt, new) in enumerate(requests(cfg.vocab)):
            inp[f"reqs/{arch}/{i}"] = prompt
            inp[f"reqs/{arch}/{i}/new"] = np.int64(new)
        if arch == "qwen3_8b":
            scheme = api.QuantScheme(fmt="elp_bsd_a4", act="static", act_bits=8)
            packed = api.quantize(cfg, params, scheme, calib_data=calib, device="cpu").params
            for key, leaf in flatten(packed, f"a4/{arch}").items():
                if isinstance(leaf, PackedWeight):
                    inp[f"{key}/codes"], inp[f"{key}/sf"] = leaf.codes.numpy(), leaf.sf.numpy()
                    inp[f"{key}/meta"] = np.asarray([leaf.shape[0], leaf.shape[1], leaf.nibble,
                                                     leaf.act_bits or 0], np.int64)
                    inp[f"{key}/act_scale"] = np.float32(leaf.act_scale)
                    inp[f"{key}/fmt"] = np.asarray(leaf.fmt_name)
                else:
                    inp[key] = leaf.numpy()
    inp["fd/tokens"] = rng.integers(0, 256, (N_SLOTS, FD_PROMPT + FD_STEPS + FD_VERIFY)).astype(
        np.int32)
    np.savez(path, **inp)


def load_requests(inp, arch) -> list:
    n = len(TRACE)
    return [(inp[f"reqs/{arch}/{i}"], int(inp[f"reqs/{arch}/{i}/new"])) for i in range(n)]


def _scales(inp, arch):
    return inp[f"kv_scales/{arch}/k"], inp[f"kv_scales/{arch}/v"]


def fd_positions():
    """The verify run's ``[B]`` positions after the prompt and the single steps."""
    base = FD_PROMPT + FD_STEPS
    return np.asarray([base, base - 1, base - 2, base], np.int32)


# ---------------------------------------------------------------------------
# The JAX package (a subprocess with 4 fake CPU devices)
# ---------------------------------------------------------------------------
def _tokens_placed(eng):
    """The JAX engine with its decode steps' token input put on the sharding their
    jit declares: under jax 0.9.0 the engine's replicated token vector does not
    match a data axis of more than one device, and the step raises (ROADMAP.md,
    reference-side caveats). The values are the same."""
    import jax
    from jax.sharding import NamedSharding

    from repro.runtime import sharding as shr

    mesh = eng.setup.mesh
    placed = NamedSharding(mesh, shr.input_spec((eng.setup.batch, 1), mesh))
    for name in ("_decode_greedy", "_decode"):
        fn = getattr(eng, name)
        setattr(eng, name, lambda p, t, *a, fn=fn: fn(p, jax.device_put(t, placed), *a))
    return eng


def jax_reference(in_path: str, out_path: str, arch: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.kernels.ops import PackedWeight
    from repro.models import transformer as jtr
    from repro.models.context import ParallelCtx
    from repro.serve import ServeEngine

    from torch_tp_ranks import packed_tree

    assert len(jax.devices()) == WORLD, jax.devices()
    inp = dict(np.load(in_path))
    res = {}
    auto = (jax.sharding.AxisType.Auto,) * 2  # GSPMD's propagation (ROADMAP, reference caveats)
    meshes = {m: jax.make_mesh(shape, ("data", "model"), axis_types=auto)
              for m, shape in MESHES.items()}
    for arch in (arch,):
        cfg = dataclasses.replace(jget(arch).reduced(), dtype_str="float32")
        params = unflatten(inp, f"params/{arch}", jnp.asarray)
        reqs = load_requests(inp, arch)
        trees = {"float": params}
        if arch == "qwen3_8b":
            trees["a4"] = packed_tree(inp, arch, PackedWeight, jnp.asarray)
        for run, (kw, mesh_names) in JAX_RUNS.items():
            kw = dict(kw)
            if kw.get("kv_cache") == "paged":
                kw["kv_scales"] = _scales(inp, arch)  # numpy: each engine's own copy
            for mname in meshes_of(arch, run, mesh_names):
                eng = _tokens_placed(ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                                                 mesh=meshes[mname], **kw))
                outs = eng.serve(reqs, arrivals=list(ARRIVALS))
                for i, o in enumerate(outs):
                    res[f"{arch}/{run}/{mname}/{i}"] = np.asarray(o)
                res[f"{arch}/{run}/{mname}/prefix_hits"] = eng.stats()["cache"]["prefix_hits"]
        if "a4" in trees:
            eng = _tokens_placed(ServeEngine(cfg, trees["a4"], n_slots=N_SLOTS, max_len=MAX_LEN,
                                             mesh=meshes[A4_MESH]))
            for i, o in enumerate(eng.serve(reqs, arrivals=list(ARRIVALS))):
                res[f"{arch}/a4/{A4_MESH}/{i}"] = np.asarray(o)

    if arch == "qwen3_8b":  # the olmoe process takes the flash-decode part
        np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})
        return
    # flash-decode on (1, 4): a prefill, single steps, one [B] verify run
    cfg = dataclasses.replace(jget("qwen3_8b").reduced(), dtype_str="float32")
    params = unflatten(inp, "params/qwen3_8b", jnp.asarray)
    mesh = meshes["1x4"]
    pctx = ParallelCtx(mesh=mesh, batch_axes=("data",), model_axis="model", flash_decode=True)
    toks = jnp.asarray(inp["fd/tokens"])
    # jitted (one compile a shape instead of op-by-op dispatch; the same ops)
    prefill = jax.jit(lambda p, t, c: jtr.prefill(p, cfg, t, c, pctx=pctx))
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, cfg, t, c, pos, pctx=pctx))
    for kind in FD_CACHES:
        cache = jtr.init_cache(cfg, N_SLOTS, MAX_LEN, quant=kind == "quant")
        with mesh:
            _, cache = prefill(params, toks[:, :FD_PROMPT], cache)
            for i in range(FD_STEPS):
                p = FD_PROMPT + i
                logits, cache = step(params, toks[:, p:p + 1], cache, jnp.int32(p))
                res[f"fd/{kind}/step{i}"] = logits
            base = FD_PROMPT + FD_STEPS
            logits, cache = step(params, toks[:, base:base + FD_VERIFY], cache,
                                 jnp.asarray(fd_positions()))
            res[f"fd/{kind}/verify"] = logits
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
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    from repro_torch.runtime import collectives
    from repro_torch.runtime.elastic import make_mesh

    inp = dict(np.load(in_path))
    meshes = {m: make_mesh(target_model=TARGET_MODEL[m], device="cpu") for m in MESHES}
    res = {"rank": rank}
    for name, fn in (("engine", _port_engine), ("fd", _port_flash_decode),
                     ("diverge", _port_diverge), ("entry", _port_entry_points)):
        collectives.reset()
        fn(res, inp, meshes)
        for kind, n in collectives.ISSUED.items():
            res[f"issued/{name}/{kind}"] = np.asarray(n)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _params(inp, arch):
    import torch

    return unflatten(inp, f"params/{arch}", lambda a: torch.from_numpy(a.copy()))


def _draft_tier(cfg, params):
    """The model drafter's tier: elp4 codes of the same weights."""
    from repro_torch import api

    return api.quantize(cfg, params, api.QuantScheme(fmt="elp4"), device="cpu").params


def _port_engine(res, inp, meshes) -> None:
    """Each run of :data:`PORT_RUNS` over each of its meshes, and without a mesh:
    the tokens, prefix hits, each rank's cache block and collectives by kind."""
    import torch

    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.runtime import collectives
    from repro_torch.serve.engine import ServeEngine

    from torch_tp_ranks import packed_tree

    for arch in ARCHS:
        cfg = config(arch)
        params = _params(inp, arch)
        draft = _draft_tier(cfg, params)
        reqs = load_requests(inp, arch)
        for run, (kw, mesh_names, _) in PORT_RUNS.items():
            kw = dict(kw, n_slots=N_SLOTS, max_len=MAX_LEN)
            if kw.get("kv_cache") == "paged":
                kw["kv_scales"] = _scales(inp, arch)
            if kw.get("spec_draft") == "model":
                kw["draft_params"] = draft
            for mname in (None,) + meshes_of(arch, run, mesh_names):
                key = f"{arch}/{run}/{mname or 'none'}"
                collectives.reset()
                eng = ServeEngine(cfg, params, mesh=meshes[mname] if mname else None, **kw)
                outs = eng.serve(reqs, arrivals=list(ARRIVALS))
                for kind, n in collectives.ISSUED.items():
                    res[f"{key}/issued/{kind}"] = n
                for i, o in enumerate(outs):
                    res[f"{key}/{i}"] = o
                st = eng.stats()
                res[f"{key}/prefix_hits"] = st["cache"]["prefix_hits"]
                res[f"{key}/steps"] = eng.steps
                res[f"{key}/cache_shape"] = np.asarray(eng._cache["k"].shape)
                res[f"{key}/rows"] = np.asarray(eng.setup.rows())
                if mname:
                    ms = st["mesh"]
                    res[f"{key}/mesh"] = np.asarray([ms["data"], ms["model"]])
        if arch == "qwen3_8b":
            a4 = packed_tree(inp, arch, PackedWeight, lambda a: torch.from_numpy(a.copy()))
            for mname in (None, A4_MESH):
                eng = ServeEngine(cfg, a4, mesh=meshes[mname] if mname else None,
                                  n_slots=N_SLOTS, max_len=MAX_LEN)
                for i, o in enumerate(eng.serve(reqs, arrivals=list(ARRIVALS))):
                    res[f"{arch}/a4/{mname or 'none'}/{i}"] = o


def _port_flash_decode(res, inp, meshes) -> None:
    """The decode steps of :func:`jax_reference`'s flash-decode part on (1, 4): the
    sequence-sharded cache's prefill, single steps and a ``[B]`` verify run."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.runtime import collectives
    from repro_torch.serve.engine import ServeSetup

    cfg = config("qwen3_8b")
    params = _params(inp, "qwen3_8b")
    toks = torch.from_numpy(inp["fd/tokens"])
    setup = ServeSetup(cfg=cfg, mesh=meshes["1x4"], max_len=MAX_LEN, batch=N_SLOTS,
                       flash_decode=True)
    pctx = setup.pctx()
    for kind in FD_CACHES:
        cache = transformer.init_cache(cfg, N_SLOTS, MAX_LEN, quant=kind == "quant",
                                       device="cpu")
        lp, cache = setup.layout(params, cache)
        res[f"fd/{kind}/cache_shape"] = np.asarray(cache["k"].shape)
        transformer.prefill(lp, cfg, toks[:, :FD_PROMPT], cache, pctx=pctx)
        for i in range(FD_STEPS):
            p = FD_PROMPT + i
            before = dict(collectives.ISSUED)
            logits, _ = transformer.decode_step(lp, cfg, toks[:, p:p + 1], cache, p, pctx=pctx)
            res[f"fd/{kind}/step{i}"] = logits
            for k, n in collectives.ISSUED.items():
                res[f"fd/{kind}/step_issued/{k}"] = n - before.get(k, 0)
        base = FD_PROMPT + FD_STEPS
        logits, _ = transformer.decode_step(lp, cfg, toks[:, base:base + FD_VERIFY], cache,
                                            torch.from_numpy(fd_positions()), pctx=pctx)
        res[f"fd/{kind}/verify"] = logits


def _port_diverge(res, inp, meshes) -> None:
    """Rank 3 submits one request with one more new token than the others do: every
    rank's engine must raise the named agreement error at its first step."""
    import time

    from repro_torch.serve.engine import ScheduleDisagreement, ServeEngine

    cfg = config("qwen3_8b")
    reqs = load_requests(inp, "qwen3_8b")
    rank = meshes["2x2"].get_rank()
    eng = ServeEngine(cfg, _params(inp, "qwen3_8b"), mesh=meshes["2x2"], n_slots=N_SLOTS,
                      max_len=MAX_LEN)
    for i, (prompt, new) in enumerate(reqs):
        eng.submit(prompt, new + (1 if i == DIVERGE_AT and rank == WORLD - 1 else 0))
    t0 = time.perf_counter()
    try:
        eng.run()
        res["diverge/error"] = ""
    except ScheduleDisagreement as e:
        res["diverge/error"] = f"{type(e).__name__}: {e}"
    res["diverge/s"] = time.perf_counter() - t0
    res["diverge/steps"] = eng.steps


def _port_entry_points(res, inp, meshes) -> None:
    """Inside the group of 4 ranks: ``launch.serve``'s engine path over the world
    mesh and ``QuantizedModel.serve(mesh="auto")``."""
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.launch import serve as launch_serve

    os.environ["WORLD_SIZE"] = str(dist.get_world_size())  # as torchrun sets it
    out = launch_serve.main(["--arch", "qwen3_8b", "--smoke", "--device", "cpu",
                             "--prompt-len", "8", "--max-new", "4", "--requests", "6"])
    res["entry/launch_mesh"] = np.asarray([out["stats"]["mesh"]["data"],
                                           out["stats"]["mesh"]["model"]])
    for i, o in enumerate(out["outputs"]):
        res[f"entry/launch/{i}"] = o
    cfg = config("qwen3_8b")
    qm = api.quantize(cfg, _params(inp, "qwen3_8b"), api.QuantScheme(fmt="elp4"), device="cpu")
    reqs = load_requests(inp, "qwen3_8b")
    for i, o in enumerate(qm.serve(reqs, n_slots=N_SLOTS, max_len=MAX_LEN, mesh="auto")):
        res[f"entry/serve_auto/{i}"] = o
    for i, o in enumerate(qm.serve(reqs, n_slots=N_SLOTS, max_len=MAX_LEN, mesh=None)):
        res[f"entry/serve_none/{i}"] = o


if __name__ == "__main__":
    if sys.argv[1] != "jax":
        raise SystemExit("usage: python tests/torch_engine_ranks.py jax IN OUT ARCH")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    jax_reference(sys.argv[2], sys.argv[3], sys.argv[4])


# ---------------------------------------------------------------------------
# Two ranks that share one card (``tests/test_torch_mesh_gpu.py``)
# ---------------------------------------------------------------------------
GPU_RUNS = {  # name -> (mesh, engine options)
    "1x2/dense": ("1x2", {}),
    "1x2/flash": ("1x2", {"flash_decode": True}),
    "1x2/paged": ("1x2", {"kv_cache": "paged", "page_size": PAGE}),
    "1x2/ngram": ("1x2", {"spec_k": SPEC_K, "spec_draft": "ngram"}),
    "2x1/dense": ("2x1", {}),
    "2x1/paged": ("2x1", {"kv_cache": "paged", "page_size": PAGE}),
}


def gpu_rank_main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One of two ranks on ``cuda:0`` over a ``gloo`` group: reduced float32 qwen3,
    elp4 codes, the engine on a ``(1, 2)`` and a ``(2, 1)`` mesh (:data:`GPU_RUNS`)
    and without one (dense, paged, ngram), each run's tokens and launches per
    route; the dense run on each mesh again with every kernel rebound to its
    plain version."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    import repro_torch.kernels.ops as ops_mod
    import repro_torch.models.transformer as transformer
    from repro_torch import api
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul, elp_bsd_matmul_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.fused_decode import fused_decode_matmul, fused_decode_matmul_plain
    from repro_torch.runtime import collectives
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.serve.engine import ServeEngine

    def launches():
        return {f"{k.__name__}/{r}": n for k in (elp_bsd_matmul, fused_decode_matmul,
                                                 flash_attention)
                for r, n in k.launches_by_route.items()}

    meshes = {"1x2": make_mesh(target_model=world), "2x1": make_mesh(target_model=1)}
    cfg = config("qwen3_8b")
    params = transformer.init_params(cfg, seed=2, device="cuda")
    packed = api.quantize(cfg, params, api.QuantScheme(fmt="elp4"), device="cuda").params
    reqs = requests(cfg.vocab)
    calib = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 2, 8)))
    scales = calibrate_kv_cache(packed, cfg, calib.to("cuda"))
    res = {}
    meshless = {f"none/{k}": (None, GPU_RUNS[f"1x2/{k}"][1]) for k in ("dense", "paged", "ngram")}
    for name, (mname, kw) in {**meshless, **GPU_RUNS}.items():
        kw = dict(kw, n_slots=N_SLOTS, max_len=MAX_LEN)
        if kw.get("kv_cache") == "paged":
            kw["kv_scales"] = scales
        before = launches()
        collectives.reset()
        outs = ServeEngine(cfg, packed, mesh=meshes[mname] if mname else None, **kw).serve(
            reqs, arrivals=list(ARRIVALS))
        torch.cuda.synchronize()
        after = launches()
        for k in after:
            res[f"{name}/launches/{k}"] = after[k] - before[k]
        for k, n in collectives.ISSUED.items():
            res[f"{name}/issued/{k}"] = n
        res[f"{name}/tokens"] = np.concatenate(outs)
    saved = (ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul, transformer.flash_attention)
    ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul = (elp_bsd_matmul_plain,
                                                           fused_decode_matmul_plain)

    def plain_flash(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)

    transformer.flash_attention = plain_flash
    try:
        for mname, mesh in meshes.items():
            before = launches()
            outs = ServeEngine(cfg, packed, mesh=mesh, n_slots=N_SLOTS,
                               max_len=MAX_LEN).serve(reqs, arrivals=list(ARRIVALS))
            res[f"plain/{mname}/tokens"] = np.concatenate(outs)
            res[f"plain/{mname}/launched"] = sum(launches().values()) - sum(before.values())
    finally:
        ops_mod.elp_bsd_matmul, ops_mod.fused_decode_matmul, transformer.flash_attention = saved
    np.savez(os.path.join(out_dir, f"gpu_rank{rank}.npz"),
             **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()
