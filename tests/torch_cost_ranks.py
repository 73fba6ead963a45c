"""Rank bodies of ``tests/test_torch_cost.py``: ``ServeEngine.decode_cost`` over 4
``gloo`` ranks, the JAX engine's compiled cost on 4 fake devices, and a hybrid
with fewer query heads than model ranks.

``make_inputs`` writes the seeded numpy inputs; ``jax_reference`` runs in a
subprocess with ``--xla_force_host_platform_device_count=4``; ``rank_main`` runs
on each of 4 ``gloo`` ranks and writes ``rank<r>.npz``.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_engine_ranks import _tokens_placed, config, flatten, unflatten  # noqa: E402

WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
TARGET_MODEL = {"1x4": 4, "2x2": 2}
ARCH = "qwen3_8b"
N_SLOTS, MAX_LEN = 4, 32
TRACE = ((8, 6), (6, 6), (8, 6), (5, 6))  # (prompt length, new tokens)
# the hybrid with 2 query heads (1 KV head) over a model axis of 4: two ranks hold none
FEW_HEADS = {"n_heads": 2, "n_kv_heads": 1}
FEW_PROMPT, FEW_NEW, FEW_BATCH = 12, 4, 2
TRAIN_SEQ, TRAIN_BATCH = 16, 4
# the expert-parallel MoE train step whose wire bytes are counted forward and backward
MOE_ARCH, MOE_SEQ, MOE_BATCH = "olmoe_1b_7b", 16, 4


def few_heads_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("recurrentgemma_2b").reduced(), dtype_str="float32",
                               **FEW_HEADS)


def make_inputs(path: str) -> None:
    from repro_torch.models import get_model

    cfg = config(ARCH)
    inp = {k: v.numpy() for k, v in flatten(
        get_model(cfg).init_params(cfg, seed=5, device="cpu"), "params").items()}
    rng = np.random.default_rng(7)
    for i, (n, new) in enumerate(TRACE):
        inp[f"reqs/{i}"] = rng.integers(0, cfg.vocab, n).astype(np.int32)
        inp[f"reqs/{i}/new"] = np.int64(new)
    few = few_heads_config()
    inp.update({k: v.numpy() for k, v in flatten(
        get_model(few).init_params(few, seed=6, device="cpu"), "few").items()})
    inp["few/prompts"] = rng.integers(0, few.vocab, (FEW_BATCH, FEW_PROMPT)).astype(np.int32)
    inp["few/train"] = rng.integers(0, few.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)
    np.savez(path, **inp)


def _requests(inp) -> list:
    return [(inp[f"reqs/{i}"], int(inp[f"reqs/{i}/new"])) for i in range(len(TRACE))]


# ---------------------------------------------------------------------------
# The JAX package (a subprocess with 4 fake CPU devices)
# ---------------------------------------------------------------------------
def jax_reference(in_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.serve import ServeEngine

    assert len(jax.devices()) == WORLD, jax.devices()
    inp = dict(np.load(in_path))
    cfg = dataclasses.replace(jget(ARCH).reduced(), dtype_str="float32")
    params = unflatten(inp, "params", jnp.asarray)
    auto = (jax.sharding.AxisType.Auto,) * 2
    res = {}
    for mname, shape in MESHES.items():
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=auto)
        eng = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, mesh=mesh)
        jitted = eng._decode_greedy  # decode_cost lowers the jitted step itself
        _tokens_placed(eng)
        for prompt, new in _requests(inp):
            eng.submit(prompt, new)
        eng.step()
        eng._decode_greedy = jitted
        for k, v in eng.decode_cost().items():
            res[f"{mname}/{k}"] = np.float64(v)
    np.savez(out_path, **res)


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
    from repro_torch.runtime.elastic import make_mesh

    inp = dict(np.load(in_path))
    meshes = {m: make_mesh(target_model=TARGET_MODEL[m], device="cpu") for m in MESHES}
    res = {"rank": rank}
    _decode_cost(res, inp, meshes)
    _few_heads(res, inp, meshes["1x4"])
    _moe_train_wire(res, meshes)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _engine(cfg, params, inp, mesh):
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, mesh=mesh)
    for prompt, new in _requests(inp):
        eng.submit(prompt, new)
    eng.step()  # every admission and the first decode step: every slot live
    return eng


def _decode_cost(res, inp, meshes) -> None:
    """Per mesh: ``decode_cost`` (and what it issued), then the same greedy decode
    step run for real on a copy of the cache under ``count_cost``, with the wire
    bytes that ``collectives.WIRE_BYTES`` counted over it; and the meshless cost."""
    import torch

    from repro_torch.launch.hlo_stats import count_cost
    from repro_torch.runtime import collectives

    cfg = config(ARCH)
    params = unflatten(inp, "params", lambda a: torch.from_numpy(a.copy()))
    for mname, mesh in {**meshes, "none": None}.items():
        eng = _engine(cfg, params, inp, mesh)
        collectives.reset()
        cost = eng.decode_cost()
        res[f"{mname}/issued_by_cost"] = sum(collectives.ISSUED.values())
        for k in ("flops", "bytes_accessed", "collective_bytes"):
            res[f"{mname}/cost/{k}"] = np.float64(cost[k])
        for kind, b in cost["by_op"].items():
            res[f"{mname}/cost/by_op/{kind}"] = np.float64(b)
        cache = {k: v.clone() for k, v in eng._dispatch_cache().items()}
        collectives.reset()
        with torch.no_grad(), count_cost() as real:
            eng._decode_greedy(eng.params, eng._tok_dev, cache, eng._pos_in())
        for k in ("flops", "bytes_accessed", "collective_bytes"):
            res[f"{mname}/real/{k}"] = np.float64(getattr(real, k))
        res[f"{mname}/real/wire_bytes"] = np.float64(sum(collectives.WIRE_BYTES.values()))
        for kind, b in collectives.WIRE_BYTES.items():
            res[f"{mname}/real/wire/{kind}"] = np.float64(b)


def _few_heads(res, inp, mesh) -> None:
    """The hybrid with 2 query heads over a model axis of 4 (two ranks attend no
    head): ``static_generate`` logits and tokens and one train step against the
    meshless ones on the same rank."""
    import torch

    from repro_torch.models import get_model
    from repro_torch.runtime.train_loop import (
        TrainSetup,
        init_opt_state,
        local_params,
        make_train_step,
    )
    from repro_torch.serve.engine import ServeSetup, build_serve_fns

    cfg = few_heads_config()
    whole = unflatten(inp, "few", lambda a: torch.from_numpy(a.copy()))
    whole = {k: v for k, v in whole.items() if k not in ("prompts", "train")}
    api = get_model(cfg)
    prompts = torch.from_numpy(inp["few/prompts"])
    max_len = FEW_PROMPT + FEW_NEW
    for name, m in (("mesh", mesh), ("none", None)):
        setup = ServeSetup(cfg=cfg, mesh=m, max_len=max_len, batch=FEW_BATCH)
        lo, hi = setup.rows()
        params, cache = setup.layout(whole, api.init_cache(cfg, hi - lo, max_len, device="cpu"))
        prefill, decode = build_serve_fns(setup, api)
        with torch.no_grad():
            logits, cache = prefill(params, {"tokens": prompts[lo:hi]}, cache)
            out = [logits[:, -1]]
            for i in range(FEW_NEW - 1):
                tok = torch.argmax(out[-1], -1).to(torch.int32)[:, None]
                logits, cache = decode(params, tok, cache, FEW_PROMPT + i)
                out.append(logits[:, -1])
        res[f"few/{name}/logits"] = setup.gather_rows(torch.stack(out, 1))
        setup = TrainSetup(cfg=cfg, mesh=m, remat=False)
        step = make_train_step(setup)
        toks = torch.from_numpy(inp["few/train"])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if m is not None:
            from repro_torch.data.pipeline import shard_batch

            batch = shard_batch({k: v.numpy() for k, v in batch.items()}, m, device="cpu")
        _, _, _, metrics = step(local_params(setup, whole), init_opt_state(setup, whole), None,
                                batch)
        for k in ("loss", "gnorm"):
            res[f"few/{name}/{k}"] = metrics[k]


def moe_batch():
    from repro_torch.configs import get_config

    toks = np.random.default_rng(9).integers(
        0, get_config(MOE_ARCH).reduced().vocab, (MOE_BATCH, MOE_SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _moe_train_wire(res, meshes) -> None:
    """Per mesh: one expert-parallel train step of the reduced float32 olmoe (no
    remat), counted on ``meta`` by ``step_cost`` and run for real under
    ``count_cost``, with what ``collectives.ISSUED`` and ``WIRE_BYTES`` counted over
    the real step, by kind."""
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.hlo_stats import count_cost, step_cost
    from repro_torch.models import get_model
    from repro_torch.runtime import collectives
    from repro_torch.runtime.train_loop import (
        TrainSetup,
        init_opt_state,
        local_params,
        make_train_step,
    )

    cfg = config(MOE_ARCH)
    whole = get_model(cfg).init_params(cfg, seed=8, device="cpu")
    for mname, mesh in meshes.items():
        setup = TrainSetup(cfg=cfg, mesh=mesh, remat=False, moe_impl="ep")
        args = (local_params(setup, whole), init_opt_state(setup, whole), None,
                shard_batch(moe_batch(), mesh, device="cpu"))
        collectives.reset()
        meta = step_cost(make_train_step(setup), *args)
        res[f"moetrain/{mname}/meta_issued"] = sum(collectives.ISSUED.values())
        with torch.enable_grad(), count_cost() as real:
            make_train_step(setup)(*args)
        for kind in collectives.KINDS:
            key = f"moetrain/{mname}/{{}}/{kind}"
            res[key.format("meta")] = np.float64(meta["by_op"].get(kind, 0.0))
            res[key.format("meta_calls")] = meta["collective_calls"].get(kind, 0)
            res[key.format("real")] = np.float64(real.by_op.get(kind, 0.0))
            res[key.format("real_calls")] = real.collective_calls.get(kind, 0)
            res[key.format("wire")] = np.float64(collectives.WIRE_BYTES[kind])
            res[key.format("issued")] = collectives.ISSUED[kind]


if __name__ == "__main__":
    jax_reference(sys.argv[2], sys.argv[3])
