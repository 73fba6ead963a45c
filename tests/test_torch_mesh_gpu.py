"""The mesh layer on the card: a one-rank NCCL group and its ``(1, 1)`` mesh.

Marked ``gpu``; the ``cuda_mesh`` fixture asks for the card (skipping where
there is none) and lays ``elastic.make_mesh()`` over a one-rank ``nccl``
group. The twins of the CPU mesh tests, held against the port's own meshless
paths (the card has no JAX):

* the engine with ``flash_decode=True`` on reduced float32 qwen3 and olmoe,
  packed a4 (the matmuls on the ``bf16x3`` routes), dense, paged int8 and
  ngram speculative: tokens and launches per route equal to the meshless
  engine's (prompts of at most 8 tokens: the expert-parallel capacity drops
  nothing);
* ``flash_decode_attention`` against ``attention_dot`` within 1e-5 of max
  |out|, float and int8 caches; ``moe_ep`` against ``moe_dense`` within 1e-5
  of max |y| at a capacity that drops nothing;
* ``compressed_mean`` on the NCCL group equal to the codec's round trip;
  three data-parallel ZeRO-1 train steps equal to the meshless steps;
* tensor parallelism with two ranks on the one card (NCCL refuses two ranks
  on one device, so a ``gloo`` group carries the card's tensors over the
  host; rank bodies in ``tests/torch_tp_ranks.py``): reduced float32 qwen3,
  a4 codes, ``static_generate`` on a ``(1, 2)`` mesh giving the meshless
  tokens with each rank launching, route by route, what the meshless run
  launches; three train steps with and without ``seq_parallel`` within
  1e-5 relative of the meshless losses;
* the continuous-batching engine over the same two ranks (rank bodies in
  ``tests/torch_engine_ranks.py``): reduced float32 qwen3, elp4 codes, on a
  ``(1, 2)`` mesh (dense, flash-decode, paged int8, ngram) and a ``(2, 1)``
  mesh (dense, paged int8), every run's tokens the meshless engine's (same
  cache, same drafter) on both ranks, every kernel's launches only where the meshless run launches it,
  one ``agree`` a step; and the dense run on each mesh with the kernels
  rebound to their plain versions giving the same tokens, launching nothing.

    python -m pytest -m gpu tests/test_torch_*.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu
ARCHS = ("qwen3_8b", "olmoe_1b_7b")
RUNS = {"dense": {}, "paged_int8": {"kv_cache": "paged", "page_size": 4},
        "ngram": {"spec_k": 3, "spec_draft": "ngram"}}


@pytest.fixture(scope="module")
def cuda_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.runtime.elastic import make_mesh

    yield make_mesh()
    torch.distributed.destroy_process_group()


def _cfg(name):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name).reduced(), dtype_str="float32")


def _launches():
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_decode import fused_decode_matmul

    return {k.__name__: dict(k.launches_by_route)
            for k in (elp_bsd_matmul, fused_decode_matmul, flash_attention)}


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_engine_on_card_matches_meshless(cuda_mesh, arch, run):
    from repro_torch import api
    from repro_torch.calib.runner import calibrate_kv_cache
    from repro_torch.models import transformer
    from repro_torch.runtime import collectives
    from repro_torch.serve.engine import ServeEngine

    cfg = _cfg(arch)
    params = transformer.init_params(cfg, seed=2, device="cuda")
    packed = api.quantize(cfg, params, api.QuantScheme(fmt="elp4"), device="cuda").params
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 6), (8, 4), (3, 7), (6, 5))]
    kw = dict(RUNS[run], n_slots=2, max_len=24)
    if run == "paged_int8":
        calib = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 2, 8))).cuda()
        kw["kv_scales"] = calibrate_kv_cache(packed, cfg, calib)
    outs, counts = {}, {}
    for meshed in (False, True):
        before = _launches()
        collectives.reset()
        outs[meshed] = ServeEngine(cfg, packed, mesh=cuda_mesh if meshed else None,
                                   flash_decode=meshed, **kw).serve(reqs)
        torch.cuda.synchronize()
        after = _launches()
        counts[meshed] = {k: {r: after[k][r] - before[k][r] for r in after[k]} for k in after}
        issued = dict(collectives.ISSUED)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    assert counts[False] == counts[True] and any(v for c in counts[True].values()
                                                 for v in c.values())
    assert issued["all_reduce"] > 0 and (issued["all_to_all"] > 0) == cfg.is_moe


@pytest.mark.parametrize("cache", ["float", "int8"])
def test_flash_decode_on_card_matches_attention_dot(cuda_mesh, cache):
    from repro_torch.models.context import ParallelCtx
    from repro_torch.models.flash_decode import flash_decode_attention
    from repro_torch.models.layers import attention_dot, repeat_kv

    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, kv, hd = 4, 512, 8, 2, 64
    q = torch.randn(b, 1, h, hd, device="cuda", generator=g)
    k = torch.randn(b, s, kv, hd, device="cuda", generator=g)
    v = torch.randn(b, s, kv, hd, device="cuda", generator=g)
    pos = torch.tensor([7, 100, 300, 511], device="cuda")
    ks = vs = None
    if cache == "int8":
        ks = torch.rand(b, s, kv, 1, device="cuda", generator=g) * 0.02
        vs = torch.rand(b, s, kv, 1, device="cuda", generator=g) * 0.02
        k = torch.randint(-127, 128, k.shape, device="cuda", generator=g).to(torch.int8)
        v = torch.randint(-127, 128, v.shape, device="cuda", generator=g).to(torch.int8)
    got = flash_decode_attention(q, k, v, pos, pctx=ParallelCtx(mesh=cuda_mesh), ks=ks, vs=vs)
    kf = k.float() if ks is None else k.float() * ks
    vf = v.float() if vs is None else v.float() * vs
    want = attention_dot(q, repeat_kv(kf, h // kv), repeat_kv(vf, h // kv), q_offset=pos)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_moe_ep_on_card_matches_dense(cuda_mesh):
    from repro_torch.models import moe
    from repro_torch.models.context import ParallelCtx

    cfg = dataclasses.replace(_cfg("olmoe_1b_7b"), moe_capacity_factor=8.0)
    g = torch.Generator(device="cuda").manual_seed(1)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {"router": torch.randn(d, e, device="cuda", generator=g) * 0.5,
         "we1": torch.randn(e, d, ff, device="cuda", generator=g) * 0.1,
         "we3": torch.randn(e, d, ff, device="cuda", generator=g) * 0.1,
         "we2": torch.randn(e, ff, d, device="cuda", generator=g) * 0.1}
    x = torch.randn(64, d, device="cuda", generator=g)
    got = moe.moe_ep(p, x, cfg, ParallelCtx(mesh=cuda_mesh))
    want = moe.moe_dense(p, x, cfg)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("codec", ["int8", "elp4"])
def test_compressed_mean_on_nccl(cuda_mesh, codec):
    from repro_torch.models.context import ParallelCtx
    from repro_torch.optim.compress import compressed_mean, round_trip

    x = torch.randn(10_000, device="cuda", generator=torch.Generator(device="cuda").manual_seed(2))
    pctx = ParallelCtx(mesh=cuda_mesh)
    assert torch.distributed.get_backend(pctx.batch_group) == "nccl"
    assert torch.equal(compressed_mean(x, pctx.batch_group, codec), round_trip(x, codec))


def test_mesh_train_steps_on_card_match_meshless(cuda_mesh):
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.models import transformer
    from repro_torch.runtime.train_loop import TrainSetup, init_opt_state, make_train_step

    cfg = _cfg("qwen3_8b")
    ds = LmDataset(cfg, seq_len=16, batch=4, seed=0)
    losses = {}
    for mesh in (None, cuda_mesh):
        setup = TrainSetup(cfg=cfg, mesh=mesh, lr_peak=1e-2, warmup=0, total_steps=10)
        params = transformer.init_params(cfg, seed=1, device="cuda")
        opt, step = init_opt_state(setup, params), make_train_step(setup)
        losses[mesh is None] = []
        for i in range(3):
            params, opt, _, m = step(params, opt, None, shard_batch(ds.np_batch(i), mesh,
                                                                    device="cuda"))
            losses[mesh is None].append(float(m["loss"]))
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-6)


@pytest.fixture(scope="module")
def two_ranks_on_one_card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.multiprocessing as mp

    import torch_tp_ranks as R

    d = tmp_path_factory.mktemp("tp_gpu")
    mp.spawn(R.gpu_rank_main, args=(2, str(d / "store"), str(d)), nprocs=2, join=True)
    return [dict(np.load(d / f"gpu_rank{r}.npz")) for r in range(2)]


def test_tensor_parallel_two_ranks_on_one_card(two_ranks_on_one_card):
    for res in two_ranks_on_one_card:
        np.testing.assert_array_equal(res["tp/tokens"], res["meshless/tokens"])
        routes = [k.split("/launches/")[1] for k in res if k.startswith("tp/launches/")]
        for r in routes:
            assert int(res[f"tp/launches/{r}"]) == int(res[f"meshless/launches/{r}"]), r
        assert sum(int(res[f"tp/launches/{r}"]) for r in routes) > 0
        assert int(res["tp/all_reduce"]) > 0 and int(res["meshless/all_reduce"]) == 0


def test_tensor_parallel_train_steps_on_one_card(two_ranks_on_one_card):
    for res in two_ranks_on_one_card:
        for name in ("tp", "sp"):
            np.testing.assert_allclose(res[f"train/{name}"], res["train/meshless"], rtol=1e-5)
        assert int(res["train/sp/reduce_scatter"]) > 0
        assert int(res["train/tp/reduce_scatter"]) == 0


@pytest.fixture(scope="module")
def families_on_two_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.multiprocessing as mp

    import torch_tp_recurrent_ranks as R

    d = tmp_path_factory.mktemp("tp_recurrent_gpu")
    mp.spawn(R.gpu_rank_main, args=(2, str(d / "store"), str(d)), nprocs=2, join=True)
    return [dict(np.load(d / f"gpu_rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_2b", "seamless_m4t_large_v2"])
def test_recurrent_families_two_ranks_on_one_card(families_on_two_ranks, arch):
    """Each recurrent and enc-dec family's reduced config on a (1, 2) mesh over two
    ranks that share the card: tokens equal on both ranks and to the meshless
    run's, the launches per route the meshless run's, and every kernel call at
    the sharded shapes within 2e-5 of max |plain| of its plain version on the
    same inputs."""
    for res in families_on_two_ranks:
        assert bool(res[f"{arch}/ranks_same"])
        np.testing.assert_array_equal(res[f"{arch}/tp/tokens"], res[f"{arch}/meshless/tokens"])
        routes = [k.split("/launches/")[1] for k in res if k.startswith(f"{arch}/tp/launches/")]
        for r in routes:
            assert int(res[f"{arch}/tp/launches/{r}"]) == int(res[f"{arch}/meshless/launches/{r}"])
        assert sum(int(res[f"{arch}/tp/launches/{r}"]) for r in routes) > 0
        assert int(res[f"{arch}/tp/all_reduce"]) > 0
        held = {k: float(v) for k, v in res.items() if k.startswith(f"{arch}/held/")}
        assert held and max(held.values()) <= 2e-5, held


@pytest.fixture(scope="module")
def engine_on_two_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.multiprocessing as mp

    import torch_engine_ranks as R

    d = tmp_path_factory.mktemp("engine_gpu")
    mp.spawn(R.gpu_rank_main, args=(2, str(d / "store"), str(d)), nprocs=2, join=True)
    return [dict(np.load(d / f"gpu_rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("run", ["1x2/dense", "1x2/flash", "1x2/paged", "1x2/ngram",
                                 "2x1/dense", "2x1/paged"])
def test_engine_two_ranks_on_one_card(engine_on_two_ranks, run):
    ranks = engine_on_two_ranks
    kind = run.split("/")[1]
    ref = f"none/{'dense' if kind == 'flash' else kind}"  # without a mesh flash changes nothing
    for res in ranks:
        np.testing.assert_array_equal(res[f"{run}/tokens"], res[f"{ref}/tokens"])
        np.testing.assert_array_equal(res[f"{run}/tokens"], ranks[0][f"{run}/tokens"])
        routes = [k.split("/launches/")[1] for k in res if k.startswith(f"{run}/launches/")]
        assert sum(int(res[f"{run}/launches/{r}"]) for r in routes) > 0
        for r in routes:  # the routes the meshless engine takes, and no other
            if int(res[f"{ref}/launches/{r}"]) == 0:
                assert int(res[f"{run}/launches/{r}"]) == 0, r
        assert int(res[f"{run}/issued/agree"]) > 0


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_engine_kernels_against_plain_on_two_ranks(engine_on_two_ranks, mesh):
    for res in engine_on_two_ranks:
        np.testing.assert_array_equal(res[f"plain/{mesh}/tokens"], res[f"{mesh}/dense/tokens"])
        assert int(res[f"plain/{mesh}/launched"]) == 0
